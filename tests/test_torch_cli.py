"""The port's CLI (``nyxus_tpu_torch/cli.py``) against the JAX package's on
tests/test_io_cli.py's shape of input (three 96 x 96 make_blobs TIFF
pairs), both on the CPU at the default precision (f32): the same files,
headers, row order and name and label columns, the values within the f32
tiers of tests/test_tpu_device.py (``chip_smoke.compare_tiers``), for
singlecsv, separatecsv, Arrow IPC, Parquet, ``--aggr``, ``--skiproi``,
``--mergerois``, ``--anisox`` / ``--anisoy``, whole-slide mode
(``--segDir`` equal to ``--intDir``) and the nested-ROI post-pass
(``--hsig/--hpar/--hchi/--hag``).  The port's files also hold the port's
own ``featurize_directory`` frame with the same settings bit for bit.
Then the Stopwatch and its timing CSV (tests/test_io_cli.py:158-203), the
device flags (the default device raises where torch sees no card), and
``python -m nyxus_tpu_torch.cli`` as a subprocess."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from conftest import make_blobs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import nyxus_tpu.cli as jcli  # noqa: E402
from nyxus_tpu.timing import Stopwatch as JStopwatch  # noqa: E402

import nyxus_tpu_torch.cli as tcli  # noqa: E402
from nyxus_tpu_torch.io import readers  # noqa: E402
from nyxus_tpu_torch.timing import Stopwatch, stopwatch  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

FEATS = "*ALL_INTENSITY*,*ALL_MORPHOLOGY*,*ALL_GLSZM*"
META = ["intensity_image", "mask_image", "ROI_label", "t_index"]
CASES = {
    "singlecsv": ["--outputType=singlecsv"],
    "separatecsv": ["--outputType=separatecsv"],
    "arrowipc": ["--outputType=arrowipc"],
    "parquet": ["--outputType=parquet"],
    "aggr": ["--outputType=singlecsv", "--aggr=true"],
    "skiproi": ["--outputType=singlecsv", "--skiproi=1,2"],
    "mergerois": ["--outputType=separatecsv", "--mergerois=true"],
    "aniso": ["--outputType=singlecsv", "--anisox=1.4", "--anisoy=0.75"],
    "wholeslide": ["--outputType=singlecsv"],
    "nested": ["--outputType=separatecsv", "--hsig=_c", "--hpar=1",
               "--hchi=0", "--hag=SUM"],
}


@pytest.fixture(autouse=True)
def stopwatches_off():
    """The CLIs turn their process-wide Stopwatch on; leave it off."""
    yield
    for sw in (Stopwatch, JStopwatch):
        sw.enable(False)
        sw.exclusive = False
        sw.reset()


@pytest.fixture(scope="module")
def tiff_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for d in ("int", "seg", "nint", "nseg"):
        (root / d).mkdir()
    for k in range(3):
        intens, labels = make_blobs(96, 96, 6, seed=k)
        readers.write_gray(str(root / "int" / ("img%d.tif" % k)), intens)
        readers.write_gray(str(root / "seg" / ("img%d.tif" % k)),
                           labels.astype(np.uint16))
    # the nested post-pass: channel 1 masks hold boxes around channel 0's
    # blobs (tests/test_nested.py's fixture), the intensity files share
    # their names
    from test_nested import _channel_pair
    par, chi = _channel_pair()
    intens = (np.arange(64 * 64).reshape(64, 64) % 251 + 7).astype(np.uint16)
    for k in range(2):
        for c, m in ((1, par), (0, chi)):
            name = "p%d_c%d.tif" % (k, c)
            readers.write_gray(str(root / "nseg" / name), m)
            readers.write_gray(str(root / "nint" / name), intens)
    return root


def _argv(root, case, out):
    int_dir, seg_dir = str(root / "int"), str(root / "seg")
    if case == "wholeslide":
        seg_dir = int_dir
    if case == "nested":
        int_dir, seg_dir = str(root / "nint"), str(root / "nseg")
    return ["--intDir=" + int_dir, "--segDir=" + seg_dir, "--outDir=" + out,
            "--features=" + FEATS] + CASES[case]


def _read(path):
    if path.endswith(".csv"):
        # numbers parsed by numpy, which keeps the sign of "-0" (pandas'
        # parsers drop it)
        df = pd.read_csv(path, dtype=str, keep_default_na=False)
        for c in df.columns:
            if c not in ("intensity_image", "mask_image", "Image"):
                df[c] = np.array(df[c].tolist(), np.float64)
        return df
    if path.endswith(".parquet"):
        return pd.read_parquet(path)
    import pyarrow as pa
    with pa.memory_map(path) as src:
        return pa.ipc.open_file(src).read_all().to_pandas()


def _port_frame(argv):
    """The port's featurize_directory frame with the CLI's settings, as
    the CLI's files hold it."""
    args = tcli.build_parser().parse_args(argv + ["--useGpu=false"])
    nyx = tcli.make_nyxus(args)
    df = nyx.featurize_directory(args.intDir, args.segDir, args.filePattern)
    if tcli._truthy(args.aggr):
        df = tcli._aggregate_per_slide(df, args.noval)
    return df


@pytest.mark.parametrize("case", list(CASES))
def test_cli_equals_jax(tiff_dirs, tmp_path, case):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jcli.main(_argv(tiff_dirs, case, jout)) == 0
    argv = _argv(tiff_dirs, case, tout)
    assert tcli.main(argv + ["--useGpu=false"]) == 0
    files = sorted(os.listdir(jout))
    assert sorted(os.listdir(tout)) == files and files
    frame = _port_frame(argv)
    rows = 0
    for name in files:
        want = _read(os.path.join(jout, name))
        got = _read(os.path.join(tout, name))
        assert list(got.columns) == list(want.columns), name
        if name.startswith("nested_"):
            meta = [c for c in want.columns
                    if c in ("Image", "Parent_Label", "Child_Label")]
        else:
            meta = META
        for c in meta:
            assert list(got[c]) == list(want[c]), (name, c)
        cols = [c for c in want.columns if c not in meta]
        if cols:
            bad, _ = chip_smoke.compare_tiers(
                cols, got[cols].to_numpy(float), want[cols].to_numpy(float))
            assert not bad, (name, bad[:10])
        if name.startswith("nested_"):
            continue
        # bit for bit: the rows of featurize_directory this file holds
        # (all of them, or one slide's in a separate CSV)
        sel = frame if name.startswith("NyxusFeatures.") \
            else frame[frame.mask_image.isin(set(got.mask_image))]
        rows += len(got)
        assert list(got.columns) == list(sel.columns), name
        for c in META:
            assert list(got[c]) == list(sel[c]), (name, c)
        g = got[sel.columns[4:]].to_numpy(float)
        s = sel[sel.columns[4:]].to_numpy(float)
        np.testing.assert_array_equal(g, s, err_msg=name)
        np.testing.assert_array_equal(np.signbit(g), np.signbit(s))
    assert rows == len(frame)
    if case == "skiproi":
        sk = _read(os.path.join(tout, "NyxusFeatures.csv"))
        assert (sk[sk.ROI_label.isin([1, 2])].MEAN == 0).all()
        assert (sk[~sk.ROI_label.isin([1, 2])].MEAN > 0).all()
    if case in ("mergerois", "wholeslide"):
        assert (frame.ROI_label == 1).all() and len(frame) == 3
    if case == "aggr":
        assert (frame.ROI_label == -1).all() and len(frame) == 3


def test_cli_timing_csv(tiff_dirs, tmp_path):
    """--exclusivetiming=true writes <seg>_nyxustiming.csv with the JAX
    CLI's header and stage keys (and discovery's)."""
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--useGpu=false"])):
        out = str(tmp_path / name)
        argv = _argv(tiff_dirs, "singlecsv", out) + ["--exclusivetiming=true"]
        assert main(argv + extra) == 0
        with open(os.path.join(out, "seg_nyxustiming.csv")) as f:
            outs[name] = f.read().splitlines()
    assert outs["port"][0] == outs["jax"][0] == "h1,h2,h3,color,seconds,calls"
    keys = {n: {tuple(ln.split(",")[:4]) for ln in lines[1:]}
            for n, lines in outs.items()}
    # JAX's file path runs discovery on its prefetch thread, outside the
    # Stopwatch; the port's keeps it in the runner, under JAX's key
    assert keys["port"] - keys["jax"] == {
        ("Pipeline", "Phase1_discovery", "#cca33a", "")}
    assert keys["jax"] <= keys["port"]
    assert ("Pipeline", "Phase2_device_batches", "#33cc77", "") in keys["port"]
    for ln in outs["port"][1:]:
        secs, calls = ln.split(",")[4:]
        assert float(secs) >= 0 and int(calls) >= 1


def test_cli_default_device_needs_a_card(tiff_dirs, tmp_path):
    """With no card, the default --useGpu=true raises rather than run on
    the CPU; so does a device index past the cards."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    argv = _argv(tiff_dirs, "singlecsv", str(tmp_path / "o"))
    for extra in ([], ["--useGpu=true", "--gpuDeviceID=0"]):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tcli.main(argv + extra)
    assert not os.path.exists(str(tmp_path / "o"))
    args = tcli.build_parser().parse_args(argv + ["--useGpu=false"])
    assert tcli.device_of(args) == "cpu"


def test_cli_dim3_raises(tiff_dirs, tmp_path):
    """--dim=3 reaches Nyxus3D's file protocol, which reads NIfTI volumes:
    on a directory of 2D TIFF pairs it raises the JAX package's CLI's
    error (tests/test_torch_3d_files_jax.py runs it on NIfTI volumes)."""
    argv = _argv(tiff_dirs, "singlecsv", str(tmp_path / "o"))
    argv += ["--dim=3", "--features=*3D_ALL*"]
    with pytest.raises(IOError, match="not a NIfTI file") as j:
        jcli.main(argv)
    with pytest.raises(IOError, match="not a NIfTI file") as t:
        tcli.main(argv + ["--useGpu=false"])
    assert str(t.value) == str(j.value)


def test_cli_subprocess(tiff_dirs, tmp_path):
    """python -m nyxus_tpu_torch.cli: exit 0 and the in-process CLI's CSV
    with --useGpu=false; a non-zero exit without it on a machine with no
    card."""
    out = str(tmp_path / "sub")
    env = dict(os.environ, PYTHONPATH=ROOT)
    argv = _argv(tiff_dirs, "singlecsv", out)
    r = subprocess.run([sys.executable, "-m", "nyxus_tpu_torch.cli"] + argv
                       + ["--useGpu=false"], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert tcli.main(argv[:2] + ["--outDir=" + str(tmp_path / "inproc")]
                     + argv[3:] + ["--useGpu=false"]) == 0
    with open(os.path.join(out, "NyxusFeatures.csv")) as a, \
            open(str(tmp_path / "inproc" / "NyxusFeatures.csv")) as b:
        assert a.read() == b.read()
    import torch
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "-m", "nyxus_tpu_torch.cli"]
                           + argv, env=env, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0 and "needs a CUDA device" in r.stderr


def test_timing_stopwatch(tmp_path):
    """Stage accumulators, exclusive mode, the CSV dump (reference:
    helpers/timing.h:9-39)."""
    import time
    Stopwatch.reset()
    Stopwatch.enable()
    with stopwatch("Outer/Stage/#ff0000"):
        time.sleep(0.02)
        with stopwatch("Outer/Inner/#00ff00"):
            time.sleep(0.02)
    inc = Stopwatch.totals(exclusive=False)
    exc = Stopwatch.totals(exclusive=True)
    assert inc["Outer/Stage/#ff0000"] >= 0.039
    assert exc["Outer/Stage/#ff0000"] < inc["Outer/Stage/#ff0000"] - 0.015
    p = str(tmp_path / "t_nyxustiming.csv")
    Stopwatch.save_csv(p)
    lines = open(p).read().splitlines()
    assert lines[0] == "h1,h2,h3,color,seconds,calls"
    assert any("Outer,Inner" in ln and "#00ff00" in ln for ln in lines)
    assert "no timing" not in Stopwatch.summary()


def test_timing_in_pipeline():
    """The runner's stages under the JAX package's keys; nothing recorded
    while the Stopwatch is off."""
    import nyxus_tpu_torch
    intens, labels = make_blobs(64, 64, 4, seed=9)
    nyx = nyxus_tpu_torch.Nyxus(["MEAN", "PERIMETER", "NUM_NEIGHBORS"],
                                device="cpu")
    Stopwatch.reset()
    nyx.featurize(intens, labels.astype(np.int32))
    assert Stopwatch.totals() == {}
    Stopwatch.enable()
    nyx.featurize(intens, labels.astype(np.int32))
    tot = Stopwatch.totals()
    for key in ("Pipeline/Phase1_discovery/#cca33a",
                "Pipeline/Contours/#777799",
                "Pipeline/Host/geom_batch/#99bb55",
                "Pipeline/Phase2_device_batches/#33cc77",
                "Pipeline/Phase2_collect/#33aa99",
                "Pipeline/Host/NeighborsFeature/#bbbbbb"):
        assert key in tot, key
