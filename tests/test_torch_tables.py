"""The PyTorch port's copied tables and host-side helpers against the JAX
package they were copied from: taxonomy, config, columns, batching, ROI
discovery and the family registry's metadata.  Also pins that importing the
port pulls in neither jax nor anything of nyxus_tpu."""

import os
import subprocess
import sys

import pytest

from conftest import make_blobs

import nyxus_tpu.columns as jcol
import nyxus_tpu.config as jconfig
import nyxus_tpu.registry as jreg
import nyxus_tpu.taxonomy as jtx
from nyxus_tpu.pipeline import batching as jbatching
from nyxus_tpu.pipeline import labels as jlabels

import nyxus_tpu_torch.columns as tcol
import nyxus_tpu_torch.config as tconfig
import nyxus_tpu_torch.registry as treg
import nyxus_tpu_torch.taxonomy as ttx
from nyxus_tpu_torch.pipeline import batching as tbatching
from nyxus_tpu_torch.pipeline import labels as tlabels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLDM*",
         "*ALL_NGTDM*", "*ALL_GLSZM*", "*ALL_GLDZM*", "*ALL_NGLDM*"]
REQUESTS = [SLICE, ["*ALL*"], ["*ALL_GLCM*"], ["*ALL_INTENSITY*", "-MEAN"],
            ["*ALL_MORPHOLOGY*"], ["*ALL_GLSZM*", "GLDM_SDE"]]


@pytest.mark.parametrize("rel", ["config.py", "columns.py",
                                 "taxonomy/__init__.py",
                                 "pipeline/batching.py"])
def test_verbatim_copies(rel):
    """Each verbatim copy is its original plus one first-line comment that
    names the source file."""
    with open(os.path.join(ROOT, "nyxus_tpu", rel)) as f:
        orig = f.read()
    with open(os.path.join(ROOT, "nyxus_tpu_torch", rel)) as f:
        first, copy = f.read().split("\n", 1)
    assert first.startswith("# Copied verbatim from nyxus_tpu/%s" % rel)
    assert copy == orig


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
    ported = [n for n, f in treg.FAMILIES.items() if f.ported]
    assert ported == ["PixelIntensityFeatures", "GLCMFeature", "GLRLMFeature",
                      "NGTDMFeature", "GLDMFeature", "NGLDMfeature",
                      "GLSZMFeature", "GLDZMFeature"]


@pytest.mark.parametrize("features", REQUESTS, ids=lambda f: ",".join(f))
def test_activated_families(features):
    assert jreg.activated_families(jtx.parse_feature_request(features)) == \
        treg.activated_families(ttx.parse_feature_request(features))


def test_import_pulls_no_jax():
    code = ("import sys, nyxus_tpu_torch\n"
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
