"""Command-line interface of the port (nyxus_tpu/cli.py, which mirrors the
reference CLI: src/nyx/main_nyxus.cpp:12-227, cli_option_constants.h:4-77).

Usage:
    python -m nyxus_tpu_torch.cli --intDir=<dir> --segDir=<dir> \\
        --outDir=<dir> --features=*ALL* \\
        [--outputType=singlecsv|separatecsv|arrowipc|parquet] ...

Every flag of the JAX package's CLI is accepted, with the same meaning and
the same output files.  ``--useGpu`` and ``--gpuDeviceID`` choose the torch
device: the default, ``--useGpu=true``, is the CUDA device (``cuda:N`` for
``--gpuDeviceID=N``) and raises where torch sees none; ``--useGpu=false``
runs on the CPU.  ``--exclusivetiming=true`` (or ``NYXUS_TIMING=1``) turns
the Stopwatch on and writes ``<seg>_nyxustiming.csv`` beside the CSV
output.  pandas and pyarrow are imported only where a frame or an Arrow
file is built.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        prog="nyxus_tpu_torch",
        description="Scalable image feature extraction on a CUDA device")
    a = p.add_argument
    a("--intDir", required=True, help="intensity image directory")
    a("--segDir", required=True, help="segmentation mask directory")
    a("--outDir", required=True, help="output directory")
    a("--intSegMapDir", default="", help="directory of the mapping file")
    a("--intSegMapFile", default="",
      help="explicit intensity<->mask pairing file (name pairs per line)")
    a("--features", default="*ALL*", help="feature list / group nicknames")
    a("--filePattern", default=".*", help="regex file pattern")
    a("--outputType", default="separatecsv",
      choices=["separatecsv", "singlecsv", "arrowipc", "parquet"])
    a("--resultFname", default="NyxusFeatures")
    a("--coarseGrayDepth", type=int, default=64)
    a("--pixelDistance", type=int, default=5)
    a("--pixelsPerCentimeter", type=float, default=0.0)
    a("--embeddedpixelsize", default="true")
    a("--onlineStatsThresh", type=int, default=1024)
    a("--reduceThreads", type=int, default=4)
    a("--ramLimit", type=int, default=4096)
    a("--tempDir", default="")
    a("--ibsi", default="false")
    a("--mergerois", default="false")
    a("--skiproi", default="")
    a("--verbose", type=int, default=0)
    a("--glcmAngles", default="0,45,90,135")
    a("--glcmOff", type=int, default=1)
    a("--gaborfreqs", default="4,16,32,64")
    a("--gabortheta", default="0,45,90,135")
    a("--gaborgamma", type=float, default=0.1)
    a("--gaborsig2lam", type=float, default=0.8)
    a("--gaborkersize", type=int, default=16)
    a("--gaborf0", type=float, default=0.1)
    a("--gaborthold", type=float, default=0.025)
    a("--noval", type=float, default=-0.0)
    a("--tinyval", type=float, default=1e-10)
    a("--aggr", default="false",
      help="aggregate all ROIs of a slide into one output row (mean)")
    a("--annot", default="false",
      help="parse filename-stem annotation tokens into anno0..N columns")
    a("--annotsep", default="_")
    a("--fpimgdr", type=float, default=1e4)
    a("--fpimgmin", type=float, default=0.0)
    a("--fpimgmax", type=float, default=1.0)
    a("--preserve-hu", dest="preserve_hu", action="store_true")
    a("--anisox", type=float, default=1.0)
    a("--anisoy", type=float, default=1.0)
    a("--anisoz", type=float, default=1.0)
    a("--dim", type=int, default=2, choices=[2, 3])
    # nested-ROI post-pass (cli_option_constants.h:50-53)
    a("--hsig", default="", help='channel signature, e.g. "_c"')
    a("--hpar", default="", help="parent channel number")
    a("--hchi", default="", help="child channel number")
    a("--hag", default="NONE",
      help="child feature aggregation: NONE, SUM, MEAN, MIN, MAX, or WMA")
    # the torch device (reference --useGpu/--gpuDeviceID)
    a("--useGpu", default="true",
      help="true (the default): the CUDA device; false: the CPU")
    a("--gpuDeviceID", type=int, default=-1,
      help="the CUDA device's index; -1 is the current device")
    a("--exclusivetiming", default="false")
    return p


def _truthy(s: str) -> bool:
    return str(s).lower() in ("true", "1", "yes", "on")


def device_of(args) -> str:
    """The torch device of ``--useGpu`` / ``--gpuDeviceID``: "cpu" only
    when the caller asks for it with ``--useGpu=false``; otherwise a CUDA
    device, and a RuntimeError where torch sees none."""
    if not _truthy(args.useGpu):
        return "cpu"
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("--useGpu=true (the default) needs a CUDA device "
                           "and torch sees none; pass --useGpu=false to run "
                           "on the CPU")
    if args.gpuDeviceID == -1:
        return "cuda"
    if not 0 <= args.gpuDeviceID < n:
        raise ValueError("--gpuDeviceID=%d out of range (%d CUDA device(s))"
                         % (args.gpuDeviceID, n))
    return "cuda:%d" % args.gpuDeviceID


def _aggregate_per_slide(df, noval):
    """--aggr: one mean row per slide, ROI_label -1, NaN terms -> noval
    (reference: output_2_csv.cpp:491-540)."""
    import pandas as pd
    rows = []
    meta = ["intensity_image", "mask_image", "ROI_label", "t_index"]
    feat_cols = [c for c in df.columns if c not in meta]
    for (iname, mname), g in df.groupby(
            ["intensity_image", "mask_image"], sort=False):
        vals = g[feat_cols].to_numpy(np.float64)
        n = len(g)
        terms = np.where(np.isfinite(vals), vals / n, noval)
        row = {"intensity_image": iname, "mask_image": mname,
               "ROI_label": -1, "t_index": 0.0}
        row.update(dict(zip(feat_cols, terms.sum(0))))
        rows.append(row)
    return pd.DataFrame(rows, columns=meta + feat_cols)


def _nested_post_pass(args, df):
    """--hsig/--hpar/--hchi/--hag: mine parent-child relations among the mask
    files and optionally aggregate child features per parent
    (reference: main_nyxus.cpp:124-135, cli_nested_roi_options.cpp:636)."""
    import re
    from .nested import aggregate_children, mine_segment_relations

    sig = re.escape(args.hsig)
    parent_pattern = ".*%s%s\\..*" % (sig, re.escape(args.hpar))
    child_pattern = ".*%s%s\\..*" % (sig, re.escape(args.hchi))
    rels = mine_segment_relations(args.segDir, parent_pattern, child_pattern,
                                  with_child_image=True)
    out = os.path.join(args.outDir, "nested_relations.csv")
    rels[["Image", "Parent_Label", "Child_Label"]].to_csv(out, index=False)
    print("wrote", out)
    if args.hag.upper() != "NONE":
        # child features come from the main run's output (the reference
        # reads back the per-child-file CSVs, nested_roi_py.cpp:aggregate_features)
        agg = aggregate_children(rels, df, args.hag)
        out = os.path.join(args.outDir, "nested_aggregated.csv")
        agg.to_csv(out)
        print("wrote", out)


# full-double CSV precision, the one io/writers.py's Arrow path uses too
_CSV_PRECISION = 17


def _rows_to_csv(nyx, ipath, lpath, labs, values, path, append):
    """Stream one slide's rows to CSV through the native writer
    (native/src/csv_writer.cpp), without a DataFrame."""
    from . import native
    vals = np.ascontiguousarray(values, np.float64)
    prefixes = ["%s,%s,%d,0" % (ipath, lpath, int(l)) for l in labs]
    header = None if append else ",".join(nyx.header)
    native.write_csv(path, header, prefixes, vals, append=append,
                     precision=_CSV_PRECISION)


def _save_timing(args, Stopwatch):
    """<seg>_nyxustiming.csv per run (reference:
    workflow_2d_segmented.cpp:369-394)."""
    base = os.path.basename(os.path.normpath(args.segDir or "run"))
    Stopwatch.save_csv(os.path.join(args.outDir, base + "_nyxustiming.csv"))
    if args.verbose >= 1:
        print(Stopwatch.summary())


def make_nyxus(args):
    """The ``Nyxus`` (``Nyxus3D`` for ``--dim=3``) of parsed arguments, on
    the device of ``device_of``, with the CLI's calibration and the
    ``--skiproi`` blacklist."""
    common = dict(
        features=[t for t in args.features.split(",") if t],
        device=device_of(args),
        coarse_gray_depth=args.coarseGrayDepth,
        neighbor_distance=args.pixelDistance,
        ibsi=_truthy(args.ibsi),
        mergerois=_truthy(args.mergerois),
        dynamic_range=args.fpimgdr,
        min_intensity=args.fpimgmin,
        max_intensity=args.fpimgmax,
        preserve_hu=args.preserve_hu,
        ram_limit=args.ramLimit,
        anisotropy_x=args.anisox,
        anisotropy_y=args.anisoy,
    )

    if args.dim == 3:
        from .api import Nyxus3D
        nyx = Nyxus3D(anisotropy_z=args.anisoz, **common)
    else:
        from .api import Nyxus
        nyx = Nyxus(
            gabor_kersize=args.gaborkersize,
            gabor_gamma=args.gaborgamma,
            gabor_sig2lam=args.gaborsig2lam,
            gabor_f0=args.gaborf0,
            gabor_thold=args.gaborthold,
            gabor_thetas=[float(v) for v in args.gabortheta.split(",")],
            gabor_freqs=[float(v) for v in args.gaborfreqs.split(",")],
            **common)
    # CLI calibration: xyRes from --pixelsPerCentimeter (default 0 =
    # uncalibrated, AREA_UM2 unassigned); pixelSizeUm = 1e4 / xyRes
    # (environment.cpp:898-904) -- overrides the Python-API default of 1.0
    ppcm = args.pixelsPerCentimeter
    nyx.cfg = nyx.cfg.replace(
        glcm_angles=tuple(int(v) for v in args.glcmAngles.split(",")),
        glcm_offset=args.glcmOff,
        noval=args.noval, tinyval=args.tinyval,
        xyres=ppcm if ppcm > 0 else 0.0,
        pixels_per_micron=(1e4 / ppcm) if ppcm > 0 else 1.0)
    nyx._compile()
    if args.skiproi and hasattr(nyx, "blacklist_roi"):
        nyx.blacklist_roi(args.skiproi)
    return nyx


def main(argv=None):
    args = build_parser().parse_args(argv)
    # the reference also accepts --opt=value tokens; argparse handles both

    from .timing import Stopwatch, set_verbosity
    set_verbosity(args.verbose)
    if _truthy(args.exclusivetiming) or Stopwatch.enabled():
        Stopwatch.enable()
        Stopwatch.exclusive = _truthy(args.exclusivetiming)

    nyx = make_nyxus(args)
    os.makedirs(args.outDir, exist_ok=True)

    if args.outputType in ("arrowipc", "parquet"):
        out = nyx.featurize_directory(args.intDir, args.segDir,
                                      args.filePattern,
                                      output_type=args.outputType,
                                      output_path=args.outDir)
        print("wrote", out)
        return 0

    # per-slide streamed CSV commit (reference:
    # workflow_2d_segmented.cpp:322-352 saves each slide's rows as it
    # finishes) -- constant memory over arbitrarily many slides.  The
    # aggregating / nested / mapping-file modes still need the full frame.
    needs_frame = (_truthy(args.aggr) or bool(args.intSegMapFile)
                   or bool(args.hsig and args.hpar and args.hchi)
                   or args.dim == 3)
    if not needs_frame:
        single = args.outputType == "singlecsv"
        out = os.path.join(args.outDir, args.resultFname + ".csv")
        # a single writer thread formats+writes each slide's CSV while the
        # next slide computes (ordering preserved: one worker, sequential
        # submits; the native writer releases the GIL)
        from concurrent.futures import ThreadPoolExecutor
        wex = ThreadPoolExecutor(max_workers=1)
        futs = []
        wrote_any = False
        for ipath, lpath, labs, values in nyx._iter_directory_raw(
                args.intDir, args.segDir, args.filePattern):
            if single:
                futs.append(wex.submit(_rows_to_csv, nyx, ipath, lpath,
                                       labs, values, out, wrote_any))
            else:
                base = os.path.splitext(
                    os.path.basename(lpath or ipath or "wholeslide"))[0]
                out_i = os.path.join(args.outDir, base + ".csv")

                def _write_one(ip=ipath, lp=lpath, lb=labs, vv=values,
                               po=out_i):
                    # 'wrote' printed AFTER the write so the log reflects
                    # reality (a failure also surfaces via fu.result())
                    _rows_to_csv(nyx, ip, lp, lb, vv, po, False)
                    print("wrote", po)

                futs.append(wex.submit(_write_one))
            wrote_any = True
        wex.shutdown(wait=True)
        for fu in futs:
            fu.result()     # surface writer errors
        if single:
            if not wrote_any:
                with open(out, "w") as f:
                    f.write(",".join(nyx.header) + "\n")
            print("wrote", out)
        if Stopwatch.enabled():
            _save_timing(args, Stopwatch)
        return 0

    if args.intSegMapFile:
        from .io import dataset as ds
        int_files, seg_files, _ = ds.read_2d_mapping(
            args.intDir, args.segDir, args.intSegMapDir or args.intDir,
            args.intSegMapFile)
        df = nyx.featurize_files(int_files, seg_files)
    else:
        df = nyx.featurize_directory(args.intDir, args.segDir,
                                     args.filePattern)

    if _truthy(args.aggr):
        df = _aggregate_per_slide(df, args.noval)

    if args.outputType == "singlecsv":
        out = os.path.join(args.outDir, args.resultFname + ".csv")
        df.to_csv(out, index=False)
        print("wrote", out)
    else:  # separatecsv: one CSV per slide (mask image)
        for seg, gdf in df.groupby("mask_image", sort=False):
            base = os.path.splitext(os.path.basename(seg or "wholeslide"))[0]
            out = os.path.join(args.outDir, base + ".csv")
            gdf.to_csv(out, index=False)
            print("wrote", out)

    if Stopwatch.enabled():
        _save_timing(args, Stopwatch)

    if args.hsig and args.hpar and args.hchi and args.dim == 2:
        _nested_post_pass(args, df)
    return 0


if __name__ == "__main__":
    sys.exit(main())
