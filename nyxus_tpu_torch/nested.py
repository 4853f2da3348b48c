# Copied verbatim from nyxus_tpu/nested.py; pinned by tests/test_torch_tables.py.
"""Nested-ROI hierarchy subsystem.

Mines parent->child ROI containment across channel-paired mask images and
aggregates child features per parent (reference: src/nyx/python/nested_roi_py.cpp:512
mine_segment_relations, :158 find_hierarchy, :227 relational-table output;
Python surface src/nyx/python/nyxus/nyxus.py:2190-2311; CLI aggregations
src/nyx/nested_feature_aggregation.h:6).

Containment test: parent AABB contains child AABB on both axes, inclusive
(nested_roi_py.cpp:184-190).  A child inside several parent boxes is recorded
under each of them, exactly like the reference's per-parent child_segs lists.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pandas as pd

# CLI-style child-feature aggregations (nested_feature_aggregation.h:6).
# The reference's WMA branch computes a plain mean (nested_roi_py.cpp default
# case), so WMA == MEAN here too.
CHILD_AGGREGATIONS = ("NONE", "SUM", "MEAN", "MIN", "MAX", "WMA")


def _label_aabbs(mask: np.ndarray):
    """label -> (ymin, ymax, xmin, xmax), vectorized over all labels."""
    flat = mask.ravel()
    nz = flat != 0
    labs = flat[nz]
    if labs.size == 0:
        return {}
    H, W = mask.shape
    pos = np.nonzero(nz)[0]
    yy = pos // W
    xx = pos % W
    uniq, inv = np.unique(labs, return_inverse=True)
    k = uniq.size
    ymin = np.full(k, H); ymax = np.full(k, -1)
    xmin = np.full(k, W); xmax = np.full(k, -1)
    np.minimum.at(ymin, inv, yy)
    np.maximum.at(ymax, inv, yy)
    np.minimum.at(xmin, inv, xx)
    np.maximum.at(xmax, inv, xx)
    return {int(uniq[i]): (int(ymin[i]), int(ymax[i]),
                           int(xmin[i]), int(xmax[i])) for i in range(k)}


def find_hierarchy(parent_mask: np.ndarray, child_mask: np.ndarray):
    """Returns {parent_label: [child_label, ...]} for parents with >=1 child
    (reference: nested_roi_py.cpp:158-226)."""
    par = _label_aabbs(parent_mask)
    chi = _label_aabbs(child_mask)
    children = {lp: [] for lp in par}
    for lc in sorted(chi):
        cy0, cy1, cx0, cx1 = chi[lc]
        for lp in sorted(par):
            py0, py1, px0, px1 = par[lp]
            if px0 <= cx0 and px1 >= cx1 and py0 <= cy0 and py1 >= cy1:
                children[lp].append(lc)
    return {lp: cs for lp, cs in children.items() if cs}


def mine_segment_relations(label_dir: str, parent_file_pattern: str,
                           child_file_pattern: str,
                           with_child_image: bool = False):
    """Relational table over every parent/child file pair
    (reference: nested_roi_py.cpp:512-601).  Patterns are regexes matched
    against pure file names.  ``with_child_image`` adds a Child_Image column
    (not part of the reference's 3-column contract; needed to disambiguate
    colliding child labels across file pairs when aggregating)."""
    from .io import readers

    def list_matching(pattern):
        rx = re.compile(pattern)
        out = []
        for name in sorted(os.listdir(label_dir)):
            if name.startswith("."):
                continue
            full = os.path.join(label_dir, name)
            if os.path.isfile(full) and rx.fullmatch(name):
                out.append(full)
        return out

    parent_files = list_matching(parent_file_pattern)
    child_files = list_matching(child_file_pattern)
    if not parent_files:
        raise RuntimeError("No parent files to process")
    if not child_files:
        raise RuntimeError("No child files to process")
    if len(parent_files) != len(child_files):
        raise RuntimeError("Parent and child channels must have the same "
                           "number of files")

    rows = []
    for pf, cf in zip(parent_files, child_files):
        pm = readers.read_gray(pf).astype(np.int64)
        cm = readers.read_gray(cf).astype(np.int64)
        hier = find_hierarchy(pm, cm)
        for lp in sorted(hier):
            for lc in hier[lp]:
                rows.append((pf, lp, lc, cf))

    cols = ["Image", "Parent_Label", "Child_Label", "Child_Image"]
    df = pd.DataFrame(rows, columns=cols)
    df["Parent_Label"] = df["Parent_Label"].astype(np.uint32)
    df["Child_Label"] = df["Child_Label"].astype(np.uint32)
    return df if with_child_image else df[cols[:3]]


_META_COLS = ("Image", "Parent_Label", "Child_Label", "Child_Image",
              "intensity_image", "mask_image", "ROI_label", "label",
              "t_index")


class Nested:
    """ROI hierarchy analyzer (reference: nyxus.py:2190-2311).

    ``aggregate`` takes any pandas aggregate spec (names, functions, or
    (name, fn) tuples); with no aggregate, ``featurize`` pivots child
    features per parent label."""

    def __init__(self, aggregate: list = []):
        self.aggregate = list(aggregate) if aggregate else []

    def find_relations(self, label_dir: str, parent_file_pattern: str,
                       child_file_pattern: str) -> pd.DataFrame:
        if not os.path.exists(label_dir):
            raise IOError("Provided label image directory '%s' does not "
                          "exist." % label_dir)
        return mine_segment_relations(label_dir, parent_file_pattern,
                                      child_file_pattern)

    def featurize(self, parent_child_map: pd.DataFrame,
                  child_features: pd.DataFrame) -> pd.DataFrame:
        label_col = "label" if "label" in child_features.columns else "ROI_label"
        joined = parent_child_map.merge(
            child_features, left_on=["Child_Label"], right_on=[label_col])
        feature_columns = [c for c in joined.columns if c not in _META_COLS]

        if not self.aggregate:
            return joined.pivot_table(index="Parent_Label",
                                      columns="Child_Label",
                                      values=feature_columns)

        agg_features = {c: self.aggregate for c in feature_columns}
        return joined.groupby(by="Parent_Label").agg(agg_features)


def aggregate_children(parent_child_map: pd.DataFrame,
                       child_features: pd.DataFrame, method: str):
    """CLI-style single-method aggregation (--hag, nested_feature_aggregation.h).

    Returns one row per parent with each feature aggregated over its
    children by ``method`` in CHILD_AGGREGATIONS."""
    method = method.upper()
    if method not in CHILD_AGGREGATIONS:
        raise ValueError("Invalid aggregation %r; valid names: %s"
                         % (method, ", ".join(CHILD_AGGREGATIONS)))
    if method == "NONE":
        return parent_child_map.copy()
    fn = {"SUM": "sum", "MEAN": "mean", "MIN": "min", "MAX": "max",
          "WMA": "mean"}[method]
    label_col = "label" if "label" in child_features.columns else "ROI_label"
    if "Child_Image" in parent_child_map.columns and \
            "mask_image" in child_features.columns:
        # disambiguate colliding child labels across file pairs: the
        # reference reads the per-child-file CSV (nested_roi_py.cpp
        # find_csv_record), which scopes labels to their mask file
        left = parent_child_map.assign(
            _cb=parent_child_map["Child_Image"].map(os.path.basename))
        right = child_features.assign(
            _cb=child_features["mask_image"].map(os.path.basename))
        joined = left.merge(right, left_on=["_cb", "Child_Label"],
                            right_on=["_cb", label_col])
    else:
        joined = parent_child_map.merge(
            child_features, left_on=["Child_Label"], right_on=[label_col])
    feature_columns = [c for c in joined.columns
                       if c not in _META_COLS and c != "_cb"
                       and np.issubdtype(joined[c].dtype, np.number)]
    return joined.groupby(["Image", "Parent_Label"])[feature_columns].agg(fn)
