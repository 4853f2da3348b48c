"""Public Python API: ``Nyxus`` for in-memory 2D pairs and ``Nyxus3D`` for
in-memory 3D volume pairs (PyTorch port of nyxus_tpu/api.py: the
``featurize`` paths, their CSV / Arrow IPC / Parquet outputs, the ROI
blacklist and the parameter surface).

Mirrors the reference's Python surface (reference:
src/nyx/python/nyxus/nyxus.py:29-909).  ``pandas`` and ``pyarrow`` are
imported only where a frame is built or a file written, so ``import
nyxus_tpu_torch`` works without them.
"""

from __future__ import annotations

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
    versions of the kernels and is meant for tests.  ``n_devices`` other
    than None, 0 or 1 raises ``NotImplementedError``: the port does not
    shard over cards yet (ROADMAP queue 1 item 10)."""

    _valid_output_types = list(_VALID_OUTPUT_TYPES)

    def __init__(self, features, device="cuda", **kwargs):
        if kwargs.get("n_devices", 1) not in (None, 0, 1):
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

        # Hounsfield-style shift + uint cast (reference: nyxus.py:469-477);
        # under preserve_hu the slope-1 offset u = round(x - floor(min)) is
        # recorded so IH_* can report in the original HU domain
        I = intensity_images
        min_raw = I.min() if I.size else 0
        hu_off = 0.0
        if self.cfg.preserve_hu:
            hu_off = float(np.floor(min_raw))
            I = np.maximum(np.round(I - hu_off), 0)
        elif min_raw < 0:
            I = I - min_raw
        if I.dtype.kind != "u":     # narrow unsigned dtypes ship as-is
            I = I.astype(np.uint32)
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
