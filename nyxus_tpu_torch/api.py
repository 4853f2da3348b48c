"""Public Python API: ``Nyxus`` for 2D pairs, in memory or as TIFF files,
``ImageQuality`` for the image-quality families over the same surface,
and ``Nyxus3D`` for 3D volume pairs, in memory, as NIfTI files or as 2.5D
stacks of slice files (PyTorch port of nyxus_tpu/api.py: ``featurize``,
the 2D and 3D file protocols ``featurize_directory`` / ``featurize_files``
with their streamed runs for slides and stacks over the RAM gate, their
pandas / Arrow IPC / Parquet outputs, the ROI blacklist, the run modes
mergerois, whole-slide / whole-volume and anisotropy, and the parameter
surface).  ``cli.py`` drives it from the command line.

Mirrors the reference's Python surface (reference:
src/nyx/python/nyxus/nyxus.py:29-1466).  ``pandas`` and ``pyarrow`` are
imported only where a frame is built or a file written, so ``import
nyxus_tpu_torch`` works without them.
"""

from __future__ import annotations

import os

import numpy as np

from . import columns as col
from . import metaparams
from . import taxonomy as tx
from .blacklist import RoiBlacklist
from .config import EngineConfig
from .pipeline.runner import PairRunner

_VALID_OUTPUT_TYPES = ("pandas", "arrowipc", "parquet")

_KWARG_MAP = {
    # constructor kwarg -> EngineConfig field
    "neighbor_distance": "pixel_distance",
    "pixels_per_micron": "pixels_per_micron",
    "coarse_gray_depth": "coarse_gray_depth",
    "n_feature_calc_threads": "n_feature_calc_threads",
    "ibsi": "ibsi",
    "mergerois": "mergerois",
    "gabor_kersize": "gabor_kersize",
    "gabor_gamma": "gabor_gamma",
    "gabor_sig2lam": "gabor_sig2lam",
    "gabor_f0": "gabor_f0",
    "gabor_thold": "gabor_thold",
    "dynamic_range": "fpimg_target_dr",
    "min_intensity": "fpimg_min",
    "max_intensity": "fpimg_max",
    "preserve_hu": "preserve_hu",
    "ram_limit": "ram_limit_mb",
    "anisotropy_x": "aniso_x",
    "anisotropy_y": "aniso_y",
    "precision": "precision",
}


def _force_finite(values: np.ndarray, noval: float) -> np.ndarray:
    """Reference: Nyxus::force_finite_number at output time."""
    out = values.copy()
    out[~np.isfinite(out)] = noval
    return out


def _prefetched(load, n):
    """Yield (k, load(k)) with item k+1 loading on a reader thread while
    item k is consumed (nyxus_tpu/api.py:50; reference: threaded tile
    loaders, abs_tile_loader.h:19)."""
    from concurrent.futures import ThreadPoolExecutor
    if n == 0:
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="nyx-prefetch")
    try:
        fut = ex.submit(load, 0)
        for k in range(n):
            item = fut.result()
            fut = ex.submit(load, k + 1) if k + 1 < n else None
            yield k, item
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _prep_slice(a):
    """A layout-A slice as ``Nyxus3D._prep`` maps a volume, where that needs
    no other slice: floored; negative values (whose shift needs the whole
    stack's minimum) raise ValueError."""
    a = np.asarray(a, np.float64)
    if a.size and a.min() < 0:
        raise ValueError("negative intensities")
    return np.floor(a)


def _stream_format(path):
    """The region-readable format of an image path: "tiff", "zarr" (a
    ``.zarr`` path or any directory), "dicom", or None."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".tif", ".tiff"):
        return "tiff"
    if ext == ".zarr" or os.path.isdir(path):
        return "zarr"
    if ext in (".dcm", ".dicom"):
        return "dicom"
    return None


class Nyxus:
    """2D feature extractor (reference: nyxus.py:29-909) on a torch device.

    ``device``: where the features are computed, "cuda" (the default, the
    current CUDA device) or e.g. "cuda:1"; "cpu" runs the plain PyTorch
    versions of the kernels and is meant for tests.  The run modes
    ``mergerois=True`` (every nonzero label one ROI), ``anisotropy_x`` /
    ``anisotropy_y`` (the nearest-neighbour resampled slide) and
    whole-slide mode (``featurize_directory`` with no mask directory)
    work in memory and streamed.

    Scale-out (nyxus_tpu/api.py's knobs): ``n_devices`` shards each ROI
    bucket over cards (None, 0 or 1: ``device`` alone; -1: every visible
    card; k: the first k cards; on the CPU, k shards of the CPU);
    ``shard_slides=True`` makes ``featurize_directory`` featurize only
    this process's share of the pairs (``parallel.process_shard``: by
    ``NYXUS_PROCESS_INDEX`` / ``NYXUS_PROCESS_COUNT``, else by the rank of
    a ``parallel.initialize_distributed`` group)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, device="cuda", **kwargs):
        self.features = list(features)
        self._blacklist = RoiBlacklist()
        updates = {}
        for k, v in kwargs.items():
            field = _KWARG_MAP.get(k)
            if field is not None and v is not None:
                updates[field] = v
        if "gabor_thetas" in kwargs:
            updates["gabor_thetas"] = tuple(kwargs["gabor_thetas"])
        if "gabor_freqs" in kwargs:
            updates["gabor_freqs"] = tuple(kwargs["gabor_freqs"])
        # Python-API calibration: xyRes = pixelSizeUm = pixels_per_micron
        # (default 1.0, new_bindings_py.cpp:93)
        updates.setdefault("xyres", float(updates.get("pixels_per_micron",
                                                      1.0)))
        # every reference entry path narrows anisotropy to C float
        for k in ("aniso_x", "aniso_y", "aniso_z"):
            if k in updates:
                updates[k] = float(np.float32(updates[k]))
        self.cfg = EngineConfig().replace(**updates)
        self.device = device
        self._n_devices = kwargs.get("n_devices", 1)
        self._shard_slides = bool(kwargs.get("shard_slides", False))
        self._compile()

    def _devices(self):
        """The devices each ROI bucket is sharded over
        (``parallel.roi_devices``; one for ``n_devices`` None, 0 or 1)."""
        from .parallel import roi_devices
        return roi_devices(self._n_devices, device=self.device)

    def use_gpu_device(self, device_id: int):
        """Select the CUDA device the features are computed on (reference:
        nyxus.py:509 use_gpu_device); -1 means the current CUDA device."""
        import torch
        n = torch.cuda.device_count()
        if device_id != -1 and not 0 <= device_id < n:
            raise ValueError("device id %d out of range (%d CUDA device(s))"
                             % (device_id, n))
        self.device = "cuda" if device_id == -1 else "cuda:%d" % device_id
        self._compile()

    def _compile(self):
        self.fset = tx.parse_feature_request(
            self.features, dim=2, ibsi=self.cfg.ibsi)
        self.header, _ = col.build_header(self.fset, self.cfg)
        self._runner = PairRunner(self.fset, self.cfg, device=self.device,
                                  devices=self._devices())

    def featurize(self, intensity_images: np.ndarray, label_images: np.ndarray,
                  intensity_names: list = (), label_names: list = (),
                  output_type: str = "pandas", output_path: str = ""):
        """Features of in-memory 2D pairs ([H, W] or [N, H, W] arrays), one
        row per ROI: a pandas DataFrame (``output_type`` "pandas"), or the
        path of the Arrow IPC or Parquet file written at ``output_path`` (a
        directory gets the default file name).  ROIs of the blacklist (a
        global label list, or per-file lists keyed by the intensity image's
        name) keep their row with unassigned values."""
        if not isinstance(intensity_images, np.ndarray):
            raise ValueError("intensity_images parameter must be numpy.ndarray")
        if not isinstance(label_images, np.ndarray):
            raise ValueError("label_images parameter must be numpy.ndarray")

        if intensity_images.ndim == 2:
            if label_images.ndim != 2:
                raise ValueError("Both intensity and label arrays must be the same dimension")
            intensity_images = intensity_images[None]
            label_images = label_images[None]
        elif intensity_images.ndim != 3:
            raise ValueError("Intensity and label arrays must be 2D or 3D")
        if intensity_images.shape != label_images.shape:
            raise ValueError("Intensity and label image arrays must have the same "
                             "number of images with matching dimensions")

        n_img = intensity_images.shape[0]
        intensity_names = list(intensity_names) or \
            ["Intensity%d" % i for i in range(n_img)]
        label_names = list(label_names) or \
            ["Segmentation%d" % i for i in range(n_img)]
        if len(intensity_names) != n_img or len(label_names) != n_img:
            raise ValueError("Number of image names must equal the number of images")

        # the same intensity map as the file protocol's, over the whole
        # stack (reference: nyxus.py:469-477)
        I, hu_off = self._prep_intensity(intensity_images)
        M = label_images.astype(np.uint32)

        import pandas as pd
        frames = []
        for i in range(n_img):
            labs, values = self._runner.run(
                I[i], M[i], blacklist=self._blacklist,
                fname=intensity_names[i], hu_offset=hu_off)
            values = _force_finite(values, self.cfg.noval)
            frames.append(self._to_frame(intensity_names[i], label_names[i],
                                         labs, values))
        if frames:
            df = pd.concat(frames, ignore_index=True)
        else:
            df = self._to_frame("", "", np.zeros(0, np.int64),
                                np.zeros((0, len(self.header) - 4)))
        if output_type == "pandas":
            return df
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types "
                             "are %s." % (output_type,
                                          self._valid_output_types))
        from .io import writers
        self._arrow_path = writers.write_dataframe(df, output_type,
                                                   output_path)
        return self._arrow_path

    def _prep_intensity(self, intens: np.ndarray):
        """(offset uint image, hu_offset): the load-time float->uint map
        (nyxus_tpu/api.py _prep_intensity).  Under preserve_hu: u =
        round(x - floor(slide_min)) clamped at 0 (reference:
        slideprops.h:48-66 uint_friendly_inten), with the offset returned
        so IH_* can undo it; otherwise a slide with negative values is
        shifted to start at 0, unsigned dtypes keep their width (uint16
        stays uint16) and the rest become uint32.  Signed integers are
        shifted in int64: an int8 or int16 slide (a signed DICOM without a
        rescale) spanning more than its type's maximum would wrap, as it
        does in the JAX package."""
        if self.cfg.preserve_hu and intens.size:
            off = float(np.floor(intens.min()))
            return np.maximum(np.round(intens - off), 0).astype(np.uint32), \
                off
        if intens.size and intens.min() < 0:
            if intens.dtype.kind == "i":
                intens = intens.astype(np.int64)
            intens = intens - intens.min()
        if intens.dtype.kind == "u":
            return intens, 0.0
        return intens.astype(np.uint32), 0.0

    # -- file-based featurization (nyxus_tpu/api.py:229-486) --------------

    def featurize_directory(self, intensity_dir: str, label_dir: str = None,
                            file_pattern: str = ".*",
                            output_type: str = "pandas",
                            output_path: str = ""):
        """Features of every image pair of a directory (reference:
        nyxus.py:291-370): the files matching ``file_pattern`` in both
        directories, paired by name.  A TIFF, DICOM or OME-Zarr pair over
        the RAM gate streams through its region source (a single-frame
        DICOM is decoded whole).  Whole-slide mode (``label_dir`` None or
        equal to ``intensity_dir``) makes each image one ROI.
        ``mergerois`` and anisotropy apply to every pair.  Returns a
        DataFrame, or the path of the Arrow IPC or Parquet file, written
        one slide at a time."""
        if not os.path.exists(intensity_dir):
            raise IOError("Provided intensity image directory '%s' does not "
                          "exist." % intensity_dir)
        if label_dir is not None and not os.path.exists(label_dir):
            raise IOError("Provided label image directory '%s' does not "
                          "exist." % label_dir)
        if label_dir is None:
            label_dir = intensity_dir
        return self._emit(self._iter_directory_frames(
            intensity_dir, label_dir, file_pattern), output_type, output_path)

    def featurize_files(self, intensity_files, mask_files, single_roi=False,
                        output_type: str = "pandas", output_path: str = ""):
        """Features of explicit file pairs (reference: nyxus.py:512-558):
        TIFF, OME-Zarr (a ``.zarr`` directory), DICOM, or any format PIL
        reads; ``single_roi`` is whole-slide mode: each intensity file is
        one ROI and ``mask_files`` is not read."""
        def frames():
            for k, ipath in enumerate(intensity_files):
                lpath = ipath if single_roi else mask_files[k]
                labs, values = self._run_pair_file(ipath, lpath, single_roi,
                                                   os.path.basename(lpath))
                values = _force_finite(values, self.cfg.noval)
                yield ipath, lpath, self._to_frame(ipath, lpath, labs, values)
        return self._emit(frames(), output_type, output_path)

    def _emit(self, frames, output_type, output_path):
        """A DataFrame of every (int_path, seg_path, frame) of ``frames``,
        or their rows streamed slide by slide into an Arrow IPC or Parquet
        file (reference: workflow_2d_segmented.cpp:322-352,
        arrow_output_stream.h:22-57), whose path it returns."""
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types "
                             "are %s." % (output_type,
                                          self._valid_output_types))
        empty = lambda: self._to_frame("", "", np.zeros(0, np.int64),
                                       np.zeros((0, len(self.header) - 4)))
        if output_type == "pandas":
            import pandas as pd
            dfs = [f for _, _, f in frames]
            return pd.concat(dfs, ignore_index=True) if dfs else empty()
        from .io import writers
        w = writers.StreamingArrowWriter(output_type, output_path)
        try:
            wrote = False
            for _, _, frame in frames:
                w.write(frame)
                wrote = True
            if not wrote:
                w.write(empty())
        finally:
            w.close()
        self._arrow_path = w.path
        return self._arrow_path

    def _iter_directory_frames(self, intensity_dir, label_dir, file_pattern):
        """(int_path, seg_path, per-slide DataFrame) one pair at a time."""
        for ipath, lpath, labs, values in self._iter_directory_raw(
                intensity_dir, label_dir, file_pattern):
            yield ipath, lpath, self._to_frame(ipath, lpath, labs, values)

    def _iter_directory_raw(self, intensity_dir, label_dir, file_pattern):
        """(int_path, seg_path, labels, values [N, n_out]) per pair of the
        directory, the frame-free backbone: it needs neither pandas nor
        pyarrow.  One reader thread decodes pair k+1 while pair k computes
        (the reference overlaps IO with compute through threaded tile
        loaders, abs_tile_loader.h:19); a read that fails raises here."""
        from .io import dataset as ds
        int_files, lab_files, wholeslide = ds.read_2d_dataset(
            intensity_dir, label_dir, file_pattern)
        pairs = list(zip(int_files, lab_files))
        if self._shard_slides:
            from .parallel import process_shard
            pairs = process_shard(pairs)
        for k, pre in _prefetched(
                lambda k: self._load_pair_arrays(*pairs[k], wholeslide),
                len(pairs)):
            ipath, lpath = pairs[k]
            labs, values = self._run_pair_file(
                ipath, lpath, wholeslide, os.path.basename(lpath or ipath),
                preloaded=pre)
            yield ipath, lpath, labs, _force_finite(values, self.cfg.noval)

    def _open_stream_source(self, ipath, lpath, wholeslide):
        """A region-read source for a TIFF, OME-Zarr or tiled multi-frame
        DICOM pair, or for one such image in whole-slide mode (labels 1
        inside the slide), or None where the pair must be decoded whole:
        another format, a mask in another format than its image, or a
        single-frame DICOM, which ``DicomTiledReader`` refuses (reference:
        grayscale_tiff.h:25, omezarr.h:10-48, nyxus_dicom_loader.h:4-19).
        Any other reader error raises."""
        from .pipeline import sources
        fmt = _stream_format(ipath)
        if fmt is None or not wholeslide and _stream_format(lpath) != fmt:
            return None
        if fmt == "tiff":
            return (sources.WholeSlideTiffSource(ipath) if wholeslide
                    else sources.TiffPairSource(ipath, lpath))
        if fmt == "zarr":
            return sources.ZarrPairSource(ipath,
                                          None if wholeslide else lpath)
        from .io.readers import UNTILED_DICOM
        try:
            return sources.DicomPairSource(ipath,
                                           None if wholeslide else lpath)
        except ValueError as e:
            if str(e) == UNTILED_DICOM:
                return None
            raise

    def _stream_gate(self, shape) -> bool:
        """True when a slide of ``shape`` must take the streamed path (16
        B/px in memory: f64 intensities and i64 labels; reference RAM gate,
        workflow_2d_segmented.cpp:124-139)."""
        H, W = shape
        return H * W * 16 > (self.cfg.ram_limit_mb << 20) // 2

    def _load_pair_arrays(self, ipath, lpath, wholeslide):
        """(intensities as ``_prep_intensity`` maps them, uint32 labels,
        hu_offset) of one pair decoded whole, or None when the pair is over
        the RAM gate and must stream (the prefetch thread's work)."""
        from .io import readers
        src = self._open_stream_source(ipath, lpath, wholeslide)
        if src is not None:
            with src:
                if self._stream_gate(src.shape):
                    return None
        intens = readers.read_gray(ipath)
        labmat = (np.ones(intens.shape, np.uint32) if wholeslide
                  else readers.read_gray(lpath).astype(np.uint32))
        if labmat.shape != intens.shape:
            raise ValueError("intensity/mask dimension mismatch: %s vs %s "
                             "(%s, %s)" % (intens.shape, labmat.shape, ipath,
                                           lpath))
        I, hu_off = self._prep_intensity(intens)
        return I, labmat, hu_off

    def _run_pair_file(self, ipath, lpath, wholeslide, fname,
                       preloaded=None):
        """Featurize one on-disk pair: decoded whole (``preloaded``, else
        read here), or, over the RAM gate, tile-streamed through its
        source (reference: phase1.cpp:104-118).  ``fname`` is the name the
        blacklist checks."""
        if preloaded is None:
            preloaded = self._load_pair_arrays(ipath, lpath, wholeslide)
        if preloaded is None:
            with self._open_stream_source(ipath, lpath, wholeslide) as src:
                return self._runner.run_streamed(
                    src, blacklist=self._blacklist, fname=fname,
                    wholeslide=wholeslide)
        I, labmat, hu_off = preloaded
        return self._runner.run(I, labmat, blacklist=self._blacklist,
                                wholeslide=wholeslide, fname=fname,
                                hu_offset=hu_off)

    # -- ROI blacklist (reference: nyxus.py:771-830) -----------------------

    def blacklist_roi(self, raw: str):
        self._blacklist.parse_raw_string(raw)

    def clear_roi_blacklist(self):
        self._blacklist.clear()

    def roi_blacklist_get_summary(self) -> str:
        return self._blacklist.summary()

    # -- Arrow accessors ----------------------------------------------------

    def get_arrow_ipc_file(self):
        return getattr(self, "_arrow_path", "")

    def get_parquet_file(self):
        return getattr(self, "_arrow_path", "")

    @staticmethod
    def arrow_is_enabled():
        try:
            import pyarrow  # noqa: F401
            return True
        except ImportError:
            return False

    # -- parameter access (reference: nyxus.py:560-770) -------------------

    def set_params(self, **params):
        updates = {}
        for k, v in params.items():
            field = _KWARG_MAP.get(k)
            if field is not None:
                updates[field] = v
            elif k == "features":
                self.features = list(v)
            elif k in ("gabor_thetas", "gabor_freqs"):
                updates[k] = tuple(v)
        if updates:
            self.cfg = self.cfg.replace(**updates)
        self._compile()

    def get_params(self, *args):
        inv = {v: k for k, v in _KWARG_MAP.items()}
        out = {"features": self.features}
        for field, kwarg in inv.items():
            out[kwarg] = getattr(self.cfg, field)
        out["gabor_thetas"] = list(self.cfg.gabor_thetas)
        out["gabor_freqs"] = list(self.cfg.gabor_freqs)
        if args:
            return {k: v for k, v in out.items() if k in args}
        return out

    def set_environment_params(self, **params):
        """Alias surface of set_params (reference: nyxus.py:718-770)."""
        self.set_params(**params)

    # -- metaparameters (reference: nyxus.py:252-289, env_metaparams.cpp) --

    def set_metaparam(self, paramval: str):
        cfg, err = metaparams.set_metaparam(self.cfg, paramval)
        if err is not None:
            raise ValueError("Invalid metaparameter value %s: %s"
                             % (paramval, err))
        self.cfg = cfg
        self._compile()

    def get_metaparam(self, paramname: str):
        val, err = metaparams.get_metaparam(self.cfg, paramname)
        if err:
            raise NameError("Invalid metaparameter name %s: %s"
                            % (paramname, err))
        return val

    # -- Gabor customization (reference: nyxus.py:660-716) -----------------

    def set_gabor_feature_params(self, **kwargs):
        valid = ("kersize", "gamma", "sig2lam", "f0", "thold", "thetas",
                 "freqs")
        for key in kwargs:
            if key not in valid:
                raise ValueError("Invalid Gabor parameter %s. The valid "
                                 "parameters are: %s" % (key, list(valid)))
        if not kwargs:
            raise IOError("Illegal arguments passed to "
                          "set_gabor_feature_params()")
        updates = {}
        if "kersize" in kwargs:
            updates["gabor_kersize"] = int(kwargs["kersize"])
        if "gamma" in kwargs:
            updates["gabor_gamma"] = float(kwargs["gamma"])
        if "sig2lam" in kwargs:
            updates["gabor_sig2lam"] = float(kwargs["sig2lam"])
        if "f0" in kwargs:
            updates["gabor_f0"] = float(kwargs["f0"])
        if "thold" in kwargs:
            updates["gabor_thold"] = float(kwargs["thold"])
        if "thetas" in kwargs:
            updates["gabor_thetas"] = tuple(float(t) for t in kwargs["thetas"])
        if "freqs" in kwargs:
            updates["gabor_freqs"] = tuple(float(f) for f in kwargs["freqs"])
        if ("thetas" in kwargs) != ("freqs" in kwargs) or (
                "thetas" in kwargs
                and len(updates["gabor_thetas"]) != len(updates["gabor_freqs"])):
            raise ValueError("Gabor thetas and freqs must be specified "
                             "together with matching lengths")
        self.cfg = self.cfg.replace(**updates)
        self._compile()

    def _to_frame(self, int_name, seg_name, labs, values):
        import pandas as pd
        n = len(labs)
        data = {
            col.COL_INTENSITY: [int_name] * n,
            col.COL_MASK: [seg_name] * n,
            col.COL_LABEL: labs.astype(np.uint32),
            col.COL_T: np.zeros(n),
        }
        for j, cname in enumerate(self.header[4:]):
            data[cname] = values[:, j]
        return pd.DataFrame(data)


class ImageQuality(Nyxus):
    """Image-quality feature extractor (nyxus_tpu/api.py:601 ImageQuality;
    reference: nyxus.py:1468-2188).

    Runs the IMQ families (focus score, local focus score, power spectrum
    slope, min/max saturation, sharpness) over whole images (a virtual ROI
    covering every pixel) or per labeled ROI when a label image is
    supplied; shares the full file/parameter surface of ``Nyxus``
    (featurize_directory, featurize_files, blacklist, set/get_params, the
    ``device`` keyword, ...).  The families are host numpy and scipy; an
    oversized ROI streams them, its power spectrum's FFT and radial sums
    on the device."""

    def __init__(self, features=("*ALL_IMQ*",), **kwargs):
        super().__init__(list(features), **kwargs)

    def _compile(self):
        self.fset = tx.parse_feature_request(self.features, imq=True)
        self.header, _ = col.build_header(self.fset, self.cfg)
        self._runner = PairRunner(self.fset, self.cfg, device=self.device,
                                  devices=self._devices())

    def featurize(self, intensity_images: np.ndarray, label_images=None,
                  intensity_names: list = (), label_names: list = (),
                  output_type: str = "pandas", output_path: str = ""):
        # whole-image quality: a constant-1 label image per slide
        # (reference: nyxus.py ImageQuality.featurize label default)
        if label_images is None:
            label_images = np.ones(np.asarray(intensity_images).shape,
                                   np.int32)
        return super().featurize(intensity_images, label_images,
                                 intensity_names, label_names,
                                 output_type, output_path)


class Nyxus3D:
    """3D feature extractor over NIfTI and OME-Zarr volumes, 2.5D
    layout-A stacks of slice files or in-memory [Z, Y, X] voxel arrays
    (reference: nyxus.py:911-1466) on a torch device.

    ``device`` as for ``Nyxus``.  The run modes ``mergerois``,
    ``anisotropy_x`` / ``anisotropy_y`` / ``anisotropy_z`` (the nearest-
    neighbour resampled volume), whole-volume mode (``featurize_files``
    with ``single_roi``), ROIs over the RAM gate (phase 3) and stacks over
    it (read a plane at a time) all work.  ``n_devices`` and
    ``shard_slides`` as for ``Nyxus``; ``shard_slides`` splits the volume
    pairs of ``featurize_directory`` (not a layout-A pattern's stacks, nor
    ``featurize_files``, as in the JAX package)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, device="cuda", **kwargs):
        self.features = list(features)
        updates = {}
        for k, v in kwargs.items():
            field = _KWARG_MAP.get(k)
            if field is not None and v is not None:
                updates[field] = v
        if kwargs.get("anisotropy_z") is not None:
            updates["aniso_z"] = kwargs["anisotropy_z"]
        # Python-API calibration: xyRes = pixelSizeUm = pixels_per_micron
        # (default 1.0, new_bindings_py.cpp:93)
        updates.setdefault("xyres", float(updates.get("pixels_per_micron",
                                                      1.0)))
        # every reference entry path narrows anisotropy to C float
        for k in ("aniso_x", "aniso_y", "aniso_z"):
            if k in updates:
                updates[k] = float(np.float32(updates[k]))
        self.cfg = EngineConfig().replace(**updates)
        self.device = device
        self._n_devices = kwargs.get("n_devices", 1)
        self._shard_slides = bool(kwargs.get("shard_slides", False))
        self._compile()

    _devices = Nyxus._devices
    use_gpu_device = Nyxus.use_gpu_device
    # metaparameter surface (the 3D-family paths are 3glcm/...,
    # 3ngtdm/radius, ...)
    set_metaparam = Nyxus.set_metaparam
    get_metaparam = Nyxus.get_metaparam

    def _compile(self):
        from .pipeline.runner3d import VolumeRunner
        self.fset = tx.parse_feature_request(
            self.features, dim=3, ibsi=self.cfg.ibsi)
        self.header, _ = col.build_header(self.fset, self.cfg)
        self._runner = VolumeRunner(self.fset, self.cfg, device=self.device,
                                    devices=self._devices())

    def featurize(self, intensity_volumes, label_volumes,
                  intensity_names: list = (), label_names: list = ()):
        """Features of in-memory [Z, Y, X] volume pairs (one pair, or lists
        of them) as a pandas DataFrame, one row per ROI."""
        if isinstance(intensity_volumes, np.ndarray) \
                and intensity_volumes.ndim == 3:
            intensity_volumes = [intensity_volumes]
            label_volumes = [label_volumes]
        import pandas as pd
        frames = []
        for i, (I, M) in enumerate(zip(intensity_volumes, label_volumes)):
            iname = intensity_names[i] if intensity_names else "Intensity%d" % i
            lname = label_names[i] if label_names else "Segmentation%d" % i
            labs, values = self._runner.run(self._prep(np.asarray(I)),
                                            np.asarray(M).astype(np.int32))
            values = _force_finite(values, self.cfg.noval)
            frames.append(self._to_frame(iname, lname, labs, values))
        if not frames:
            return self._empty_frame()
        return pd.concat(frames, ignore_index=True)

    _to_frame = Nyxus._to_frame

    def _empty_frame(self):
        return self._to_frame("", "", np.zeros(0, np.int64),
                              np.zeros((0, len(self.header) - 4)))

    # -- the file protocol (nyxus_tpu/api.py:697-860) ----------------------

    def featurize_directory(self, intensity_dir: str, label_dir: str,
                            file_pattern: str = ".*",
                            output_type: str = "pandas",
                            output_path: str = ""):
        """Features of every volume pair of a directory (reference:
        nyxus.py:1006-1098): NIfTI files (``.nii``, ``.nii.gz``) paired by
        name, each time point of a 4D file its own frame rows; or, where
        ``file_pattern`` is a layout-A pattern (a ``{set d+}`` z field, e.g.
        ``vol{d+}_z{set d+}.tif``), 2.5D volumes, one a z-stack of 2D slice
        files.  A stack over the RAM gate is read a plane at a time
        (``sources.LayoutAStack``); one with negative intensities, or under
        mergerois or anisotropy, is stacked whole.  Returns a DataFrame,
        or the path of the Arrow IPC or Parquet file, written one volume at
        a time."""
        from .io import dataset as ds
        from .io.strpat import StringPattern

        if not os.path.exists(intensity_dir):
            raise IOError("Provided intensity image directory '%s' does not "
                          "exist." % intensity_dir)
        if label_dir is not None and not os.path.exists(label_dir):
            raise IOError("Provided label image directory '%s' does not "
                          "exist." % label_dir)
        if label_dir is None:
            label_dir = intensity_dir
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types "
                             "are %s." % (output_type,
                                          self._valid_output_types))
        if StringPattern.is_layoutA_fpattern(file_pattern):
            frames = self._iter_layout_a(intensity_dir, label_dir,
                                         file_pattern)
        else:
            int_files, lab_files, _ = ds.read_3d_dataset(
                intensity_dir, label_dir, file_pattern)
            pairs = list(zip(int_files, lab_files))
            if self._shard_slides:
                from .parallel import process_shard
                pairs = process_shard(pairs)
            frames = self._iter_volume_pairs(pairs)
        return self._emit(frames, output_type, output_path)

    def featurize_files(self, intensity_files, mask_files, single_roi=False,
                        output_type: str = "pandas", output_path: str = ""):
        """Features of explicit volume file pairs, NIfTI or OME-Zarr
        (reference: nyxus.py:1100-1190); ``single_roi`` is whole-volume
        mode: each intensity volume is one ROI over its one-past box and
        ``mask_files`` is not read."""
        if intensity_files is None:
            raise IOError("The list of intensity file paths is empty")
        if mask_files is None and not single_roi:
            raise IOError("The list of segment file paths is empty")
        if output_type not in self._valid_output_types:
            raise ValueError("Invalid output type %s. Valid output types "
                             "are %s." % (output_type,
                                          self._valid_output_types))
        pairs = [(ipath, ipath if single_roi else mask_files[k])
                 for k, ipath in enumerate(intensity_files)]
        return self._emit(self._iter_volume_pairs(pairs,
                                                  single_roi=single_roi),
                          output_type, output_path)

    def _emit(self, frames, output_type, output_path):
        """pandas: the frames concatenated; arrow/parquet: streamed into
        the file a volume at a time, whose path it returns (reference:
        workflow_3d_whole.cpp:172-186)."""
        if output_type == "pandas":
            import pandas as pd
            dfs = list(frames)
            return pd.concat(dfs, ignore_index=True) if dfs else \
                self._empty_frame()
        from .io import writers
        w = writers.StreamingArrowWriter(output_type, output_path)
        try:
            wrote = False
            for frame in frames:
                w.write(frame)
                wrote = True
            if not wrote:
                w.write(self._empty_frame())
        finally:
            w.close()
        self._arrow_path = w.path
        return self._arrow_path

    def _iter_layout_a(self, intensity_dir, label_dir, file_pattern):
        """Frames of the 2.5D volumes of a directory: stack k+1 is read on
        a reader thread while stack k computes (reference: phase2_25d.cpp,
        Imgfile3D_layoutA; a thread a volume, workflow_3d_whole.cpp:294)."""
        from .io import dataset as ds
        from .io import readers
        from .pipeline.sources import LayoutAStack

        groups = list(ds.read_3d_layoutA(intensity_dir, label_dir,
                                         file_pattern))

        def stacked(k):
            _, ipaths, lpaths = groups[k]
            return (np.stack([readers.read_gray(p) for p in ipaths]),
                    np.stack([readers.read_gray(p) for p in lpaths]))

        def load_stack(k):
            # the RAM gate (the reference tile-streams 2.5D like 2D,
            # phase1.cpp:130 gatherRoisMetrics_25D): a stack over it is
            # read lazily, a plane at a time
            _, ipaths, lpaths = groups[k]
            try:
                stack = LayoutAStack(ipaths, lpaths, prep=_prep_slice)
                D, H, W = stack.full_shape
                if D * H * W * 16 > (self.cfg.ram_limit_mb << 20) // 2:
                    return stack
            except ValueError:
                pass
            return stacked(k)

        for k, vols in _prefetched(load_stack, len(groups)):
            key = groups[k][0]
            labs = None
            if not isinstance(vols, tuple):
                try:
                    labs, values = self._runner.run(vols.intens, vols.labels)
                except ValueError:
                    # negative intensities mid-stack, or a mode the lazy
                    # stack does not serve: stack it whole
                    vols = stacked(k)
            if labs is None:
                ivol, lvol = vols
                labs, values = self._runner.run(self._prep(ivol),
                                                lvol.astype(np.int32))
            values = _force_finite(values, self.cfg.noval)
            yield self._to_frame(os.path.join(intensity_dir, key),
                                 os.path.join(label_dir, key), labs, values)

    def _iter_volume_pairs(self, pairs, single_roi=False):
        """Frames of a list of volume file pairs; volume k+1 is read on a
        reader thread while volume k computes."""
        from .io import readers

        def load(k):
            ipath, lpath = pairs[k]
            ivol, imeta = readers.read_volume(ipath, with_meta=True)
            if single_roi:
                lvol = np.ones(ivol.shape, np.int32)
            else:
                lvol, _ = readers.read_volume(lpath, with_meta=True)
            return ivol, imeta, lvol

        for k, (ivol, imeta, lvol) in _prefetched(load, len(pairs)):
            ipath, lpath = pairs[k]
            yield self._featurize_volume_arrays(
                ipath, "" if single_roi else lpath, ivol, imeta, lvol,
                wholeslide=single_roi)

    def _featurize_volume_pair(self, ipath, lpath, single_roi=False):
        """One volume pair, read and featurized serially (the no-prefetch
        baseline of ``_iter_volume_pairs``)."""
        from .io import readers
        ivol, imeta = readers.read_volume(ipath, with_meta=True)
        if single_roi:
            lvol = np.ones(ivol.shape, np.int32)
        else:
            lvol, _ = readers.read_volume(lpath, with_meta=True)
        return self._featurize_volume_arrays(
            ipath, "" if single_roi else lpath, ivol, imeta, lvol,
            wholeslide=single_roi)

    def _featurize_volume_arrays(self, ipath, lname, ivol, imeta, lvol,
                                 wholeslide=False):
        """The frame of one [T, Z, Y, X] volume pair: a time point's rows
        with its index in the time column; a label volume with fewer time
        points serves the later ones with its first."""
        import pandas as pd
        nt = max(imeta["nt"], 1)
        frames = []
        for t in range(nt):
            lt = lvol[t] if lvol.shape[0] > t else lvol[0]
            labs, values = self._runner.run(self._prep(ivol[t]),
                                            lt.astype(np.int32),
                                            wholeslide=wholeslide)
            values = _force_finite(values, self.cfg.noval)
            f = self._to_frame(ipath, lname, labs, values)
            f[col.COL_T] = float(t)
            frames.append(f)
        return pd.concat(frames, ignore_index=True)

    # -- Arrow accessors ----------------------------------------------------

    get_arrow_ipc_file = Nyxus.get_arrow_ipc_file
    get_parquet_file = Nyxus.get_parquet_file
    arrow_is_enabled = staticmethod(Nyxus.arrow_is_enabled)

    def _prep(self, vol: np.ndarray) -> np.ndarray:
        """Shift a volume with negative values to start at 0, then floor
        (nyxus_tpu/api.py:875)."""
        vol = np.asarray(vol, np.float64)
        if vol.size and vol.min() < 0:
            vol = vol - vol.min()
        return np.floor(vol)

    def set_params(self, **params):
        updates = {}
        for k, v in params.items():
            field = _KWARG_MAP.get(k)
            if field is not None:
                updates[field] = v
            elif k == "features":
                self.features = list(v)
        if updates:
            self.cfg = self.cfg.replace(**updates)
        self._compile()

    def get_params(self, *args):
        inv = {v: k for k, v in _KWARG_MAP.items()}
        out = {"features": self.features}
        for field, kwarg in inv.items():
            out[kwarg] = getattr(self.cfg, field)
        if args:
            return {k: v for k, v in out.items() if k in args}
        return out

    set_environment_params = Nyxus.set_environment_params
