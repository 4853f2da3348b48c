"""Public Python API: ``Nyxus`` for 2D pairs, in memory or as TIFF files,
``ImageQuality`` for the image-quality families over the same surface,
and ``Nyxus3D`` for in-memory 3D volume pairs (PyTorch port of
nyxus_tpu/api.py: ``featurize``, the 2D file protocol
``featurize_directory`` / ``featurize_files`` with its tile-streamed run
for slides over the RAM gate, their pandas / Arrow IPC / Parquet outputs,
the ROI blacklist, the run modes mergerois, whole-slide and anisotropy,
and the parameter surface).  ``cli.py`` drives it from the command line.

Mirrors the reference's Python surface (reference:
src/nyx/python/nyxus/nyxus.py:29-909).  ``pandas`` and ``pyarrow`` are
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


class Nyxus:
    """2D feature extractor (reference: nyxus.py:29-909) on a torch device.

    ``device``: where the features are computed, "cuda" (the default, the
    current CUDA device) or e.g. "cuda:1"; "cpu" runs the plain PyTorch
    versions of the kernels and is meant for tests.  The run modes
    ``mergerois=True`` (every nonzero label one ROI), ``anisotropy_x`` /
    ``anisotropy_y`` (the nearest-neighbour resampled slide) and
    whole-slide mode (``featurize_directory`` with no mask directory)
    work in memory and streamed.  ``n_devices`` other
    than None, 0 or 1 and ``shard_slides`` raise ``NotImplementedError``:
    the port does not shard over cards or processes yet (ROADMAP queue 1
    item 10)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, device="cuda", **kwargs):
        if kwargs.get("n_devices", 1) not in (None, 0, 1) \
                or kwargs.get("shard_slides"):
            raise NotImplementedError(
                "nyxus_tpu_torch does not support multi-device 2D yet: "
                "ROADMAP.md queue 1 item 10 [S 15] (multi-GPU)")
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
        self._compile()

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
        self._runner = PairRunner(self.fset, self.cfg, device=self.device)

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
        stays uint16) and the rest become uint32."""
        if self.cfg.preserve_hu and intens.size:
            off = float(np.floor(intens.min()))
            return np.maximum(np.round(intens - off), 0).astype(np.uint32), \
                off
        if intens.size and intens.min() < 0:
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
        directories, paired by name.  Whole-slide mode (``label_dir`` None
        or equal to ``intensity_dir``) makes each image one ROI; a TIFF
        slide over the RAM gate then streams through
        ``WholeSlideTiffSource``.  ``mergerois`` and anisotropy apply to
        every pair.  Returns a DataFrame, or the path of the Arrow IPC or
        Parquet file, written one slide at a time."""
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
        """Features of explicit file pairs (reference: nyxus.py:512-558);
        ``single_roi`` is whole-slide mode: each intensity file is one
        ROI and ``mask_files`` is not read."""
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
        from concurrent.futures import ThreadPoolExecutor

        from .io import dataset as ds
        int_files, lab_files, wholeslide = ds.read_2d_dataset(
            intensity_dir, label_dir, file_pattern)
        pairs = list(zip(int_files, lab_files))
        if not pairs:
            return
        ex = ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="nyx-prefetch")
        try:
            fut = ex.submit(self._load_pair_arrays, *pairs[0], wholeslide)
            for k, (ipath, lpath) in enumerate(pairs):
                pre = fut.result()
                if k + 1 < len(pairs):
                    fut = ex.submit(self._load_pair_arrays, *pairs[k + 1],
                                    wholeslide)
                labs, values = self._run_pair_file(
                    ipath, lpath, wholeslide, os.path.basename(lpath or ipath),
                    preloaded=pre)
                yield ipath, lpath, labs, _force_finite(values,
                                                        self.cfg.noval)
        finally:
            ex.shutdown(wait=True, cancel_futures=True)

    def _open_stream_source(self, ipath, lpath, wholeslide):
        """A region-read source for a TIFF pair, or for one TIFF in
        whole-slide mode (``WholeSlideTiffSource``: labels 1 inside the
        slide), or None where the pair must be decoded whole: other
        formats (reference: grayscale_tiff.h:25 tile loaders)."""
        from .pipeline import sources
        tiff = (".tif", ".tiff")
        if os.path.splitext(ipath)[1].lower() not in tiff:
            return None
        if wholeslide:
            return sources.WholeSlideTiffSource(ipath)
        if os.path.splitext(lpath)[1].lower() not in tiff:
            return None
        return sources.TiffPairSource(ipath, lpath)

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
        self._runner = PairRunner(self.fset, self.cfg, device=self.device)

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
    """3D feature extractor over in-memory [Z, Y, X] voxel arrays (reference:
    nyxus.py:911-1466) on a torch device.

    ``device`` as for ``Nyxus``.  Not ported yet, each raising
    ``NotImplementedError`` naming its ROADMAP item: 3D anisotropy
    (``anisotropy_*`` other than 1), whole-volume mode, lazy 2.5D stacks,
    ``mergerois``, oversized ROIs, ``featurize_directory`` /
    ``featurize_files`` (the NIfTI file protocol) and ``n_devices`` other
    than 1."""

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
        if kwargs.get("n_devices", 1) not in (None, 0, 1):
            from .pipeline.runner3d import _unported
            raise _unported(15, "multi-device 3D")
        self.cfg = EngineConfig().replace(**updates)
        self.device = device
        self._compile()

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
        self._runner = VolumeRunner(self.fset, self.cfg, device=self.device)

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
            return self._to_frame("", "", np.zeros(0, np.int64),
                                  np.zeros((0, len(self.header) - 4)))
        return pd.concat(frames, ignore_index=True)

    _to_frame = Nyxus._to_frame

    def featurize_directory(self, *args, **kwargs):
        from .pipeline.runner3d import _unported
        raise _unported(6, "featurize_directory (the NIfTI file protocol)")

    def featurize_files(self, *args, **kwargs):
        from .pipeline.runner3d import _unported
        raise _unported(6, "featurize_files (the NIfTI file protocol)")

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
