"""The port's ``Nested`` (nyxus_tpu_torch/nested.py, a verbatim copy of
the JAX package's) against the JAX package's on tests/test_nested.py's
fixture: containment, the relations mined from mask files read by the
port's readers, the aggregations and the pivot over child features that
the port computes, and the CLI-style ``aggregate_children``."""

import numpy as np
import pandas as pd
import pytest

import nyxus_tpu
from nyxus_tpu import nested as jnested

import nyxus_tpu_torch
from nyxus_tpu_torch import nested as tnested
from nyxus_tpu_torch.io import readers

from test_nested import _channel_pair
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)


@pytest.fixture(scope="module")
def nested_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("nested")
    par, chi = _channel_pair()
    for k in range(2):
        readers.write_gray(str(root / ("p%d_c1.tif" % k)), par)
        readers.write_gray(str(root / ("p%d_c0.tif" % k)), chi)
    return str(root)


@pytest.fixture(scope="module")
def child_features():
    _, chi = _channel_pair()
    return nyxus_tpu_torch.Nyxus(["AREA_PIXELS_COUNT", "MEAN"], device="cpu",
                                 precision="f64").featurize(
        (chi * 3).astype(np.uint16), chi.astype(np.int32))


def test_exported_lazily():
    assert nyxus_tpu_torch.Nested is tnested.Nested
    assert "Nested" in nyxus_tpu_torch.__all__


def test_find_hierarchy():
    par, chi = _channel_pair()
    assert tnested.find_hierarchy(par, chi) == \
        jnested.find_hierarchy(par, chi) == {1: [10, 11], 2: [12]}


def test_find_relations(nested_dir):
    t = tnested.Nested().find_relations(nested_dir, r"p.*_c1\.tif",
                                        r"p.*_c0\.tif")
    j = nyxus_tpu.Nested().find_relations(nested_dir, r"p.*_c1\.tif",
                                          r"p.*_c0\.tif")
    pd.testing.assert_frame_equal(t, j)
    assert len(t) == 6
    for fn in (tnested.mine_segment_relations,
               jnested.mine_segment_relations):
        full = fn(nested_dir, r"p.*_c1\.tif", r"p.*_c0\.tif",
                  with_child_image=True)
        assert list(full.columns) == ["Image", "Parent_Label", "Child_Label",
                                      "Child_Image"]


@pytest.mark.parametrize("args,exc", [
    (("/nonexistent_dir_xyz", ".*", ".*"), IOError),
    ((None, r"nomatch\.tif", r"p.*_c0\.tif"), RuntimeError),
    ((None, r"p0_c1\.tif", r"p.*_c0\.tif"), RuntimeError),
])
def test_find_relations_errors(nested_dir, args, exc):
    args = (args[0] or nested_dir,) + args[1:]
    for nn in (tnested.Nested(), nyxus_tpu.Nested()):
        with pytest.raises(exc):
            nn.find_relations(*args)


@pytest.mark.parametrize("aggregate", [[("mymin", "min"), ("mymax", "max")],
                                       ["mean", "sum"], []],
                         ids=["min-max", "mean-sum", "pivot"])
def test_featurize_equals_jax(nested_dir, child_features, aggregate):
    rels = tnested.Nested().find_relations(nested_dir, r"p0_c1\.tif",
                                           r"p0_c0\.tif")
    t = tnested.Nested(aggregate=aggregate).featurize(rels, child_features)
    j = nyxus_tpu.Nested(aggregate=aggregate).featurize(rels, child_features)
    pd.testing.assert_frame_equal(t, j)
    if aggregate and aggregate[0][0] == "mymin":
        assert t.loc[1, ("AREA_PIXELS_COUNT", "mymin")] == 16
        assert t.loc[1, ("AREA_PIXELS_COUNT", "mymax")] == 24
    if not aggregate:
        assert t.loc[1, ("AREA_PIXELS_COUNT", 10)] == 16
        assert np.isnan(t.loc[2, ("AREA_PIXELS_COUNT", 10)])


@pytest.mark.parametrize("method", ["NONE", "SUM", "MEAN", "MIN", "MAX",
                                    "WMA"])
def test_aggregate_children_equals_jax(nested_dir, child_features, method):
    rels = tnested.mine_segment_relations(nested_dir, r"p0_c1\.tif",
                                          r"p0_c0\.tif")
    t = tnested.aggregate_children(rels, child_features, method)
    j = jnested.aggregate_children(rels, child_features, method)
    pd.testing.assert_frame_equal(t, j)
    if method == "SUM":
        assert t.droplevel("Image").loc[1, "AREA_PIXELS_COUNT"] == 40


def test_aggregate_children_bad_method(nested_dir, child_features):
    rels = tnested.mine_segment_relations(nested_dir, r"p0_c1\.tif",
                                          r"p0_c0\.tif")
    with pytest.raises(ValueError):
        tnested.aggregate_children(rels, child_features, "BOGUS")
