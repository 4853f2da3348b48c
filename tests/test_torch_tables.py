"""The PyTorch port's copied tables and host-side helpers against the JAX
package they were copied from: taxonomy, config, columns, batching, ROI
discovery (2D and 3D), the host features and their native geometry
library, the 3D surface pass, and the family registry's metadata.  Also pins that importing the port pulls in
neither jax nor anything of nyxus_tpu, and that the port's native library
builds without libtiff and raises when it cannot be built."""

import inspect
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_blobs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

import nyxus_tpu.columns as jcol
import nyxus_tpu.config as jconfig
import nyxus_tpu.registry as jreg
import nyxus_tpu.taxonomy as jtx
import nyxus_tpu.native as jnative  # noqa: E402
from nyxus_tpu.pipeline import batching as jbatching  # noqa: E402
from nyxus_tpu.pipeline import labels as jlabels  # noqa: E402
from nyxus_tpu.pipeline import runner as jrunner  # noqa: E402
from nyxus_tpu.pipeline import oversized3d as joversized3d  # noqa: E402
from nyxus_tpu.pipeline import runner3d as jrunner3d  # noqa: E402

import nyxus_tpu_torch.columns as tcol
import nyxus_tpu_torch.config as tconfig
import nyxus_tpu_torch.registry as treg
import nyxus_tpu_torch.taxonomy as ttx
import nyxus_tpu_torch.native as tnative  # noqa: E402
from nyxus_tpu_torch.pipeline import batching as tbatching  # noqa: E402
from nyxus_tpu_torch.pipeline import hostfeats as thostfeats  # noqa: E402
from nyxus_tpu_torch.pipeline import labels as tlabels  # noqa: E402
from nyxus_tpu_torch.pipeline import runner as trunner  # noqa: E402
from nyxus_tpu_torch.pipeline import runner3d as trunner3d  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)
from jax_native import jax_native_loaded  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
         "*ALL_NGTDM*", "*ALL_GLSZM*", "*ALL_GLDZM*", "*ALL_NGLDM*"]
REQUESTS = [SLICE, ["*ALL*"], ["*ALL_GLCM*"], ["*ALL_INTENSITY*", "-MEAN"],
            ["*ALL_MORPHOLOGY*"], ["*ALL_GLSZM*", "GLDM_SDE"]]


@pytest.mark.parametrize("rel", ["config.py", "columns.py", "metaparams.py",
                                 "taxonomy/__init__.py",
                                 "pipeline/batching.py",
                                 "pipeline/hostfeats.py",
                                 "io/writers.py", "blacklist.py",
                                 "io/strpat.py", "io/dataset.py",
                                 "pipeline/contour.py", "timing.py",
                                 "nested.py", "pipeline/oversized_tex.py",
                                 "pipeline/oversized_extra.py",
                                 "ops/imq.py", "io/zarr.py", "io/dicom.py",
                                 "io/jpegls.py", "pipeline/labels.py"])
def test_verbatim_copies(rel):
    """Each verbatim copy is its original plus one first-line comment that
    names the source file."""
    with open(os.path.join(ROOT, "nyxus_tpu", rel)) as f:
        orig = f.read()
    with open(os.path.join(ROOT, "nyxus_tpu_torch", rel)) as f:
        first, copy = f.read().split("\n", 1)
    assert first.startswith("# Copied verbatim from nyxus_tpu/%s" % rel)
    assert copy == orig


@pytest.mark.parametrize("name", ["contour.cpp", "geomfeats.cpp",
                                  "geomfeats_batch.cpp", "csv_writer.cpp",
                                  "discover.cpp"])
def test_native_sources_are_verbatim_copies(name):
    """The host-geometry library's C++ sources: each is its original plus
    one first-line comment that names the source file."""
    with open(os.path.join(ROOT, "nyxus_tpu", "native", "src", name)) as f:
        orig = f.read()
    with open(os.path.join(ROOT, "nyxus_tpu_torch", "native", "src",
                           name)) as f:
        first, copy = f.read().split("\n", 1)
    assert first.startswith("// Copied verbatim from nyxus_tpu/native/src/%s"
                            % name)
    assert copy == orig


def test_zarr_codec_copy():
    """zarr_codec.cpp is the JAX package's but for zlib: the first line
    names the source and what differs, the LZ4 block codec, the byte
    shuffle and the blosc-LZ4 writer are the original's text, and the
    whole is the original with the <zlib.h> include dropped and the zlib
    block's inflate replaced by the -4 that hands the container to
    Python."""
    with open(os.path.join(ROOT, "nyxus_tpu", "native", "src",
                           "zarr_codec.cpp")) as f:
        orig = f.read()
    with open(os.path.join(ROOT, "nyxus_tpu_torch", "native", "src",
                           "zarr_codec.cpp")) as f:
        first, copy = f.read().split("\n", 1)
    assert first.startswith("// Copied from nyxus_tpu/native/src/"
                            "zarr_codec.cpp less zlib")

    def part(text, start, end):
        return text[text.index(start):text.index(end)]
    for start, end in (("// LZ4 block format", "// c-blosc1 container"),
                       ("// single-block blosc1+lz4 writer",
                        '}  // extern "C"')):
        assert part(copy, start, end) == part(orig, start, end)
    inflate = """            uLongf outlen = neblock;
            if (uncompress(bout, &outlen, bsrc, cbytes) != Z_OK ||
                (int)outlen != neblock)
                return -1;
"""
    assert copy == orig.replace("#include <zlib.h>\n", "").replace(
        inflate, "            return -4;                     "
                 "// inflated by the caller\n")
    assert "zlib.h" not in copy and "uncompress(" not in copy


def test_native_contours_and_geometry_equal_jax():
    """contours_batch and geom_batch of the port's library equal the JAX
    package's on the 320 x 320 slide, bit for bit (the same sources and
    flags), and so do the pixel clouds the runner feeds geom_batch."""
    intens, labels = bench.make_dsb_like(320, 320, 40, seed=11)
    recs, _, _ = tlabels._discover_rois_np(intens, labels)
    tk = tnative.contours_batch(labels, intens, recs)
    jk = jnative.contours_batch(labels, intens, recs)
    assert len(tk) == len(jk) == len(recs)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a, b)
    clouds = trunner._build_clouds(recs, intens, labels)
    jclouds = jrunner._build_clouds(recs, list(range(len(recs))), set(),
                                    (intens, labels), None)
    for a, b in zip(clouds, jclouds):
        np.testing.assert_array_equal(a, b)
    hc = trunner.HostContext(recs, tk, None, None)
    contours, recs_mat, flags = thostfeats._geom_inputs(hc)
    groups = thostfeats.G_LOGW
    for g in thostfeats.GEOM_GROUPS.values():
        groups |= g
    t_out, t_lw = tnative.geom_batch(clouds, contours, recs_mat, flags, groups,
                                     logw_eps=0.001, want_logw=True)
    j_out, j_lw = jnative.geom_batch(clouds, contours, recs_mat, flags, groups,
                                     logw_eps=0.001, want_logw=True)
    assert t_out.shape == (len(recs), thostfeats.GEOM_W)
    np.testing.assert_array_equal(t_out.view(np.uint64), j_out.view(np.uint64))
    np.testing.assert_array_equal(t_lw.view(np.uint64), j_lw.view(np.uint64))


_CXX_LOG = """#!/bin/sh
echo "$@" >> "%s"
exec g++ "$@"
"""


def _port_copy(tmp_path):
    dst = tmp_path / "nyxus_tpu_torch"
    shutil.copytree(os.path.join(ROOT, "nyxus_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return str(tmp_path)


def test_native_build_links_no_libtiff(tmp_path):
    """A fresh copy of the port builds its host library (discovery,
    geometry, the CSV writer, the TIFF codec and the Zarr chunk codec) with
    neither -ltiff nor -lz nor the JAX package's TIFF reader, and links
    neither libtiff nor zlib."""
    root = _port_copy(tmp_path)
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(_CXX_LOG % log)
    cxx.chmod(0o755)
    env = dict(os.environ, CXX=str(cxx), PYTHONPATH=root)
    code = ("import nyxus_tpu_torch.native as n\n"
            "assert n.available() is True\n"
            "print(n.LIB_PATH)\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                         env=env, capture_output=True, text=True, timeout=300)
    lib = out.stdout.strip().splitlines()[-1]
    assert lib.startswith(root)
    args = log.read_text()
    assert "-ltiff" not in args and "-lz" not in args.split()
    assert "tiff_reader" not in args
    assert "zarr_codec" in args and "discover.cpp" in args
    for src in tnative.SOURCES:
        assert src in args
    assert "-ffp-contract=off" in args and "-march=native" in args
    ldd = subprocess.run(["ldd", lib], capture_output=True, text=True,
                         timeout=60).stdout
    assert "libtiff" not in ldd and "libz.so" not in ldd


def test_native_build_failure_raises(tmp_path):
    """With no working compiler the port's loader raises, and raises again,
    rather than report the library unavailable and fall back."""
    root = _port_copy(tmp_path)
    env = dict(os.environ, CXX="false", PYTHONPATH=root)
    code = ("import nyxus_tpu_torch.native as n\n"
            "for _ in range(2):\n"
            "    try:\n"
            "        n.available()\n"
            "    except RuntimeError as e:\n"
            "        assert 'native build' in str(e), e\n"
            "    else:\n"
            "        raise SystemExit('no error')\n"
            "print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == "raised"


@pytest.mark.parametrize("dtype", [np.bool_, np.uint8, np.uint16, np.int32,
                                   np.uint32, np.int64, np.uint64])
def test_native_labels_ok(dtype):
    small = np.zeros((4, 4), dtype)
    small[1, 1] = 1
    assert tlabels._native_labels_ok(small) == jlabels._native_labels_ok(small)
    if np.dtype(dtype).itemsize >= 4 and np.dtype(dtype) != np.int32:
        big = small.copy()
        big[2, 2] = 2 ** 31 + 5
        assert tlabels._native_labels_ok(big) is False
        assert jlabels._native_labels_ok(big) is False


def test_taxonomy_data_copy():
    """The generated taxonomy data: everything after the module docstring
    is the original's text, and every table is equal."""
    import nyxus_tpu.taxonomy._data as jdata
    import nyxus_tpu_torch.taxonomy._data as tdata

    def body(path):
        with open(path) as f:
            s = f.read()
        return s[s.index('"""', s.index('"""') + 3) + 3:]
    assert body(jdata.__file__) == body(tdata.__file__)
    names = [n for n in vars(jdata) if n.isupper()]
    assert names and names == [n for n in vars(tdata) if n.isupper()]
    for n in names:
        assert getattr(jdata, n) == getattr(tdata, n), n


def test_config_fields():
    j = jconfig.EngineConfig()
    t = tconfig.EngineConfig()
    assert [f.name for f in j.__dataclass_fields__.values()] == \
        [f.name for f in t.__dataclass_fields__.values()]
    for name in j.__dataclass_fields__:
        assert getattr(j, name) == getattr(t, name), name
    for fam in ("glcm", "glrlm", "gldm", "ngtdm", "glszm", "gldzm"):
        assert j.replace(coarse_gray_depth=-64).texture_greydepth(fam) == \
            t.replace(coarse_gray_depth=-64).texture_greydepth(fam)


@pytest.mark.parametrize("features", REQUESTS, ids=lambda f: ",".join(f))
@pytest.mark.parametrize("depth", [64, -64])
def test_build_header(features, depth):
    jf = jtx.parse_feature_request(features)
    tf = ttx.parse_feature_request(features)
    assert (jf.enabled == tf.enabled).all()
    assert jcol.build_header(jf, jconfig.EngineConfig(coarse_gray_depth=depth)) \
        == tcol.build_header(tf, tconfig.EngineConfig(coarse_gray_depth=depth))


def test_slice_width():
    tf = ttx.parse_feature_request(SLICE)
    hdr, _ = tcol.build_header(tf, tconfig.EngineConfig())
    assert len(hdr) - 4 == 337


def test_bucket_shape():
    for h in range(1, 300, 7):
        for w in (1, 5, 8, 9, 17, 33, 64, 65, 200, 257, 600):
            assert jbatching.bucket_shape(h, w) == tbatching.bucket_shape(h, w)


def test_discovery_and_grouping():
    intens, labels = make_blobs(seed=4)
    jr, jmin, jmax = jlabels._discover_rois_np(intens, labels)
    tr, tmin, tmax = tlabels._discover_rois_np(intens, labels)
    assert (jmin, jmax) == (tmin, tmax)
    assert [vars(r) for r in jr] == [vars(r) for r in tr]
    for budget in (1 << 30, 1 << 16):
        assert jbatching.group_rois(jr, hbm_budget_bytes=budget) == \
            tbatching.group_rois(tr, hbm_budget_bytes=budget)


def test_registry_metadata():
    """The port declares every JAX family, in order, with its metadata."""
    assert list(jreg.FAMILIES) == list(treg.FAMILIES)
    for name, jf in jreg.FAMILIES.items():
        tf = treg.FAMILIES[name]
        assert tf.codes == jf.codes, name
        assert tf.deps == jf.deps, name
        assert tf.domain == jf.domain, name
        assert tf.device == (jf.fn is not None), name
        assert tf.host == (jf.host_fn is not None), name
        assert tf.needs_contour == jf.needs_contour, name
        assert tf.host_needs_contour == jf.host_needs_contour, name
        assert tf.needs_logw == jf.needs_logw, name
    # every half (device, host) the JAX family has, the port has
    ported = [n for n, f in treg.FAMILIES.items()
              if (f.fn is not None) == f.device
              and (f.host_fn is not None) == f.host]
    assert ported == list(jreg.FAMILIES)
    assert len(ported) == 35


@pytest.mark.parametrize("features", REQUESTS, ids=lambda f: ",".join(f))
def test_split_host_families(features):
    jf = jtx.parse_feature_request(features)
    tf = ttx.parse_feature_request(features)
    assert jreg.split_host_families(jf) == treg.split_host_families(tf)
    assert jreg.contour_needed(jf) == treg.contour_needed(tf)


@pytest.mark.parametrize("features", REQUESTS, ids=lambda f: ",".join(f))
def test_activated_families(features):
    assert jreg.activated_families(jtx.parse_feature_request(features)) == \
        treg.activated_families(ttx.parse_feature_request(features))


@pytest.mark.parametrize("jfn,tfn", [
    (jrunner3d.Roi3D, trunner3d.Roi3D),
    (jrunner3d.discover_rois_3d, trunner3d.discover_rois_3d),
    (jrunner3d.VolumeRunner._surface, trunner3d.VolumeRunner._surface),
    (joversized3d.is_oversized3d, trunner3d.is_oversized3d),
    (jrunner3d._aniso_bbox3, trunner3d._aniso_bbox3),
    (jrunner3d.discover_rois_3d_streamed, trunner3d.discover_rois_3d_streamed),
    (jrunner3d.VolumeRunner._surface_wholevolume,
     trunner3d.VolumeRunner._surface_wholevolume),
], ids=lambda f: f.__qualname__)
def test_verbatim_3d_host_code(jfn, tfn):
    """The 3D ROI record, discovery, oversized gate and surface pass are
    the JAX module's code, line for line (docstrings aside)."""
    def body(f):
        src = inspect.getsource(f)
        doc = f.__doc__
        if doc and not isinstance(f, type):
            src = src.replace('"""%s"""' % doc, "")
        return [ln for ln in src.splitlines() if ln.strip()]
    assert body(jfn) == body(tfn)


@pytest.mark.parametrize("jname,tname", [
    ("nyxus_tpu.pipeline.labels:aniso_bbox",
     "nyxus_tpu_torch.pipeline.labels:aniso_bbox"),
    ("nyxus_tpu.pipeline.sources:AnisoResampledSource",
     "nyxus_tpu_torch.pipeline.sources:AnisoResampledSource"),
    ("nyxus_tpu.pipeline.sources:MergedLabelSource",
     "nyxus_tpu_torch.pipeline.sources:MergedLabelSource"),
    ("nyxus_tpu.pipeline.sources:ZarrPairSource",
     "nyxus_tpu_torch.pipeline.sources:ZarrPairSource"),
    ("nyxus_tpu.pipeline.sources:DicomPairSource",
     "nyxus_tpu_torch.pipeline.sources:DicomPairSource"),
    ("nyxus_tpu.cli:_aggregate_per_slide",
     "nyxus_tpu_torch.cli:_aggregate_per_slide"),
    ("nyxus_tpu.cli:_nested_post_pass",
     "nyxus_tpu_torch.cli:_nested_post_pass"),
], ids=lambda s: s.split(":")[-1])
def test_verbatim_run_mode_code(jname, tname):
    """The anisotropic box, the resampling, merged-label, OME-Zarr and
    tiled-DICOM sources and the CLI's aggregation and nested post-pass are
    the JAX package's text, docstrings included."""
    import importlib

    def src(name):
        mod, attr = name.split(":")
        return inspect.getsource(getattr(importlib.import_module(mod), attr))
    assert src(jname) == src(tname)


def test_cli_flags_are_jax_flags():
    """The port's CLI parses every flag of the JAX package's CLI, with the
    same defaults and choices."""
    import nyxus_tpu.cli as jcli
    import nyxus_tpu_torch.cli as tcli

    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                         a.type, a.required)
                for a in parser._actions if a.dest != "help"}
    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_discovery_3d():
    from conftest import make_blobs3d
    intens, labels = make_blobs3d(seed=6)
    labels[0, 0, :3] = 9                    # a ROI on the volume's edge
    j = jrunner3d.discover_rois_3d(intens, labels)
    t = trunner3d.discover_rois_3d(intens, labels)
    assert j[1:] == t[1:] and len(t[0]) >= 3
    assert [vars(r) for r in j[0]] == [vars(r) for r in t[0]]
    empty = np.zeros_like(labels)
    assert jrunner3d.discover_rois_3d(intens, empty) == \
        trunner3d.discover_rois_3d(intens, empty)


def test_import_pulls_no_jax():
    code = ("import sys, nyxus_tpu_torch\n"
            "import nyxus_tpu_torch.native, nyxus_tpu_torch.pipeline.hostfeats\n"
            "import nyxus_tpu_torch.pipeline.runner3d\n"
            "import nyxus_tpu_torch.ops.texture3d, nyxus_tpu_torch.ops.ih\n"
            "import nyxus_tpu_torch.blacklist, nyxus_tpu_torch.api\n"
            "import nyxus_tpu_torch.io.tiff, nyxus_tpu_torch.io.readers\n"
            "import nyxus_tpu_torch.io.dataset, nyxus_tpu_torch.io.strpat\n"
            "import nyxus_tpu_torch.pipeline.sources\n"
            "import nyxus_tpu_torch.pipeline.contour\n"
            "import nyxus_tpu_torch.cli, nyxus_tpu_torch.timing\n"
            "import nyxus_tpu_torch.pipeline.oversized\n"
            "import nyxus_tpu_torch.pipeline.oversized_tex\n"
            "import nyxus_tpu_torch.pipeline.oversized_extra\n"
            "import nyxus_tpu_torch.pipeline.imq_streamed\n"
            "import nyxus_tpu_torch.pipeline.oversized3d\n"
            "import nyxus_tpu_torch.ops.imq\n"
            "import nyxus_tpu_torch.io.zarr, nyxus_tpu_torch.io.dicom\n"
            "import nyxus_tpu_torch.io.jpegls\n"
            "import nyxus_tpu_torch.parallel.mesh\n"
            "import nyxus_tpu_torch.parallel.dataset\n"
            "import nyxus_tpu_torch.pipeline.labels\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'nyxus_tpu' or m.startswith('nyxus_tpu.')"
            " or m == 'pandas']\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=120)


def test_sources_name_no_jax():
    """No module of the port imports jax or the JAX package."""
    pkg = os.path.join(ROOT, "nyxus_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                for line in f:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        assert "jax" not in s and "nyxus_tpu." not in s \
                            and s.split()[1] != "nyxus_tpu", (fn, s)


def test_ih_members_and_blacklist_copy():
    """The port's IH member order is the JAX package's, and its blacklist
    parses, checks and summarises as the JAX package's does."""
    from nyxus_tpu.blacklist import RoiBlacklist as JBlack
    from nyxus_tpu.ops import ih as jih
    from nyxus_tpu_torch.blacklist import RoiBlacklist as TBlack
    from nyxus_tpu_torch.ops import ih as tih
    assert tih.MEMBERS == jih.MEMBERS and len(tih.MEMBERS) == 46
    for raw in ("27,28,30", "f1.tif:5,6;f2.tif:1"):
        j, t = JBlack(), TBlack()
        j.parse_raw_string(raw)
        t.parse_raw_string(raw)
        assert j.summary() == t.summary()
        for f, lab in (("f1.tif", 5), ("f2.tif", 5), ("x", 28), ("f2.tif", 1)):
            assert j.check(f, lab) == t.check(f, lab)


@pytest.mark.parametrize("rel", ["pipeline/oversized.py",
                                 "pipeline/imq_streamed.py",
                                 "pipeline/oversized3d.py"])
def test_ported_copies_name_their_source(rel):
    """The phase-3 modules whose finish stages became torch: the first line
    names the JAX module they were copied from."""
    with open(os.path.join(ROOT, "nyxus_tpu_torch", rel)) as f:
        first = f.readline()
    assert first.startswith("# Ported from nyxus_tpu/%s;" % rel)


_PHASE3_NUMPY = {
    "oversized": ("is_oversized", "OversizedAccums", "_merge_hist",
                  "_to_binned", "accumulate", "compactness_pass",
                  "_pad_pow2", "_central_from_raw", "_central_any_sign",
                  "_signed_pow_np", "moments_members",
                  "basic_morphology_members", "ellipse_members", "_pow2",
                  "_agg_zones"),
    "imq_streamed": ("_frame_reader", "saturation_streamed", "_lap_var_sums",
                     "focus_score_streamed", "sharpness_streamed",
                     "_streamed_median_abs_dev"),
}


@pytest.mark.parametrize("mod,name", [(m, n) for m, names in
                                      _PHASE3_NUMPY.items() for n in names],
                         ids=lambda v: v)
def test_verbatim_phase3_code(mod, name):
    """The numpy halves of the ported phase-3 modules (the RAM gate, the
    accumulators, the moment, morphology and ellipse members, the streamed
    focus, saturation and sharpness) are the JAX module's text."""
    import importlib
    j = importlib.import_module("nyxus_tpu.pipeline." + mod)
    t = importlib.import_module("nyxus_tpu_torch.pipeline." + mod)
    assert inspect.getsource(getattr(j, name)) == \
        inspect.getsource(getattr(t, name))


_SLICE_3D_VERBATIM = {
    "io.readers": ("_nifti_blob", "read_nifti", "write_nifti"),
    "pipeline.sources": ("_LazyVol", "LayoutAStack"),
    "pipeline.oversized3d": ("_shift2", "_pair_hist_np", "Runs3DAccum",
                             "Zones3DAccum", "_border_distance_np",
                             "is_oversized3d", "_surface_members"),
}


@pytest.mark.parametrize("mod,name", [(m, n) for m, names in
                                      _SLICE_3D_VERBATIM.items()
                                      for n in names], ids=lambda v: v)
def test_verbatim_3d_file_and_phase3_code(mod, name):
    """The NIfTI reader and writer, the lazy layout-A stack and the numpy
    halves of 3D phase 3 (the run and zone accumulators, the border
    distance, the RAM gate, the surface members) are the JAX module's
    text."""
    import importlib
    j = importlib.import_module("nyxus_tpu." + mod)
    t = importlib.import_module("nyxus_tpu_torch." + mod)
    assert inspect.getsource(getattr(j, name)) == \
        inspect.getsource(getattr(t, name))


def test_nifti_dtypes_and_3d_accumulation_copy():
    """The NIfTI type table is the JAX package's, and ``accumulate3d``'s
    body is ``process3d``'s up to its finish, line for line, less the one
    line that picks a JAX dtype."""
    from nyxus_tpu.io import readers as jreaders
    from nyxus_tpu_torch.io import readers as treaders
    from nyxus_tpu_torch.pipeline import oversized3d as toversized3d
    assert treaders._NIFTI_DTYPES == jreaders._NIFTI_DTYPES
    jsrc = inspect.getsource(joversized3d.process3d).splitlines()
    jsrc = jsrc[jsrc.index("    D_, H_, W_ = rec.depth, rec.height, rec.width"):
                jsrc.index("    # --- finalize via the SAME jitted statistics "
                           "as the dense path -------")]
    jsrc = [ln for ln in jsrc if "jnp." not in ln]
    tsrc = inspect.getsource(toversized3d.accumulate3d).splitlines()
    tsrc = tsrc[tsrc.index("    D_, H_, W_ = rec.depth, rec.height, rec.width"):
                tsrc.index("    return Accum3D(")]
    assert [ln for ln in tsrc if ln.strip()] == \
        [ln for ln in jsrc if ln.strip()]


def test_oversized_tables():
    """The streamable families, the texture families, the accumulators'
    caps and the RAM gate's verdicts are the JAX package's."""
    from nyxus_tpu.pipeline import oversized as jovs
    from nyxus_tpu_torch.pipeline import oversized as tovs
    assert tovs.STREAMABLE == jovs.STREAMABLE and len(tovs.STREAMABLE) == 26
    assert tovs.TEX_FAMILIES == jovs.TEX_FAMILIES
    for k in ("_MAX_UNIQUES", "_FALLBACK_BINS", "_GLDZM_PLANE_CAP"):
        assert getattr(tovs, k) == getattr(jovs, k), k
    assert not hasattr(trunner, "is_oversized") or \
        trunner.is_oversized is tovs.is_oversized
    for h in (1, 7, 64, 65, 255, 256, 257, 1000, 8192, 8193, 20000):
        for w in (1, 33, 256, 512, 4097, 8193):
            r = tlabels.RoiRecord(1, h * w, 0, h - 1, 0, w - 1, 0, 1)
            for budget in (0, 1 << 20, 1 << 28, 4096 << 20):
                assert tovs.is_oversized(r, budget) == \
                    jovs.is_oversized(r, budget), (h, w, budget)
