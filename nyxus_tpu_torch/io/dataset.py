# Copied verbatim from nyxus_tpu/io/dataset.py; pinned by tests/test_torch_tables.py.
"""Dataset assembly: directory scan + file-pattern match + int/seg pairing.

Reference: src/nyx/dirs_and_files.cpp:49-180 (read_2D_dataset).  Files are
selected by a regex file pattern in both directories, sorted, and paired by
identical filenames; whole-slide mode when the label dir is empty or equals
the intensity dir.
"""

from __future__ import annotations

import os
import re


def list_files(directory: str, file_pattern: str = ".*"):
    rx = re.compile(file_pattern)
    out = []
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if os.path.isfile(p) and rx.fullmatch(name):
            out.append(p)
    return out


def read_2d_dataset(int_dir: str, seg_dir: str, file_pattern: str = ".*"):
    """Returns (intens_files, label_files, wholeslide). label entries are ""
    in whole-slide mode."""
    if not os.path.isdir(int_dir):
        raise IOError("cannot access directory " + int_dir)
    intens = list_files(int_dir, file_pattern)
    wholeslide = (not seg_dir) or os.path.abspath(seg_dir) == os.path.abspath(int_dir)
    if wholeslide:
        return intens, [""] * len(intens), True
    if not os.path.isdir(seg_dir):
        raise IOError("cannot access directory " + seg_dir)
    labels = list_files(seg_dir, file_pattern)
    if not intens or not labels:
        raise ValueError(
            "no intensity and/or label files to process, probably due to "
            "file pattern " + file_pattern)
    if len(intens) != len(labels):
        raise ValueError("mismatch: %d intensity images vs %d mask images"
                         % (len(intens), len(labels)))
    ib = {os.path.basename(p) for p in intens}
    lb = {os.path.basename(p) for p in labels}
    missing = ib - lb
    if missing:
        raise ValueError("intensity images have no matching mask: %s"
                         % sorted(missing)[:5])
    return intens, labels, False


def read_3d_dataset(int_dir: str, seg_dir: str, file_pattern: str = ".*"):
    """3D volume pairing (reference: dirs_and_files.cpp read_3D_dataset):
    same name-match pairing as 2D over volume files (.nii/.nii.gz)."""
    return read_2d_dataset(int_dir, seg_dir, file_pattern)


def read_2d_mapping(int_dir: str, seg_dir: str, map_dir: str, map_file: str):
    """Explicit intensity->mask pairing via a mapping file of
    whitespace-separated name pairs (reference: dirs_and_files.cpp:118-160)."""
    if not os.path.isdir(map_dir):
        raise IOError("cannot access directory " + map_dir)
    map_path = os.path.join(map_dir, map_file)
    if not os.path.isfile(map_path):
        raise IOError("cannot access file " + map_path)
    intens, labels = [], []
    with open(map_path) as f:
        for lineno, ln in enumerate(f, 1):
            parts = ln.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError("cannot recognize a file name pair in line "
                                 "#%d - %s" % (lineno, ln.strip()))
            ipath = os.path.join(int_dir, parts[0])
            spath = os.path.join(seg_dir, parts[1])
            if not os.path.isfile(ipath):
                raise IOError("cannot access file " + ipath)
            if not os.path.isfile(spath):
                raise IOError("cannot access file " + spath)
            intens.append(ipath)
            labels.append(spath)
    if not intens:
        raise ValueError("special mapping %s produced no intensity-label "
                         "file pairs" % map_path)
    return intens, labels, False


def read_3d_layoutA(int_dir: str, seg_dir: str, file_pattern: str):
    """Layout-A z-stack grouping (reference: readDirectoryFiles_3D +
    Imgfile3D_layoutA, dirs_and_files.h:32-75): files whose names differ only
    in the {set d+} digits form one volume.

    Returns [(volume_key, [int slice paths], [seg slice paths])] with slices
    in ascending z order."""
    from .strpat import StringPattern, group_zstack

    sp = StringPattern(file_pattern)
    if not sp.good():
        raise ValueError("bad file pattern '%s': %s"
                         % (file_pattern, sp.ermsg))
    ivols = group_zstack(sorted(os.listdir(int_dir)), sp)
    lvols = group_zstack(sorted(os.listdir(seg_dir)), sp)
    out = []
    for key in sorted(ivols):
        if key not in lvols:
            raise ValueError("mismatch: intensity volume %s has no mask" % key)
        iz, lz = ivols[key], lvols[key]
        if iz != lz:
            raise ValueError("z-stack mismatch for %s: intensity %d slices "
                             "vs mask %d" % (key, len(iz), len(lz)))
        ipaths = [os.path.join(int_dir, key.replace("*", z)) for z in iz]
        lpaths = [os.path.join(seg_dir, key.replace("*", z)) for z in lz]
        out.append((key, ipaths, lpaths))
    if not out:
        raise ValueError("No intensity and/or label file pairs to process, "
                         "probably due to file pattern " + file_pattern)
    return out
