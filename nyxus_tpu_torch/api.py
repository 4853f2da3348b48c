"""Public Python API: ``Nyxus`` for in-memory 2D pairs (PyTorch port of
nyxus_tpu/api.py, the ``featurize`` path).

Mirrors the reference's Python surface (reference:
src/nyx/python/nyxus/nyxus.py:29-909).  ``pandas`` is imported only where a
frame is built, so ``import nyxus_tpu_torch`` works without it.
"""

from __future__ import annotations

import numpy as np

from . import columns as col
from . import taxonomy as tx
from .config import EngineConfig
from .pipeline.runner import PairRunner

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
    versions of the kernels and is meant for tests."""

    def __init__(self, features, device="cuda", **kwargs):
        self.features = list(features)
        updates = {}
        for k, v in kwargs.items():
            field = _KWARG_MAP.get(k)
            if field is not None and v is not None:
                updates[field] = v
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
                  output_type: str = "pandas"):
        """Features of in-memory 2D pairs ([H, W] or [N, H, W] arrays) as a
        pandas DataFrame, one row per ROI."""
        if output_type != "pandas":
            raise NotImplementedError(
                "nyxus_tpu_torch writes pandas frames only, not %r"
                % (output_type,))
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

        # Hounsfield-style shift + uint cast (reference: nyxus.py:469-477)
        I = intensity_images
        min_raw = I.min() if I.size else 0
        if self.cfg.preserve_hu:
            I = np.maximum(np.round(I - np.floor(min_raw)), 0)
        elif min_raw < 0:
            I = I - min_raw
        if I.dtype.kind != "u":     # narrow unsigned dtypes ship as-is
            I = I.astype(np.uint32)
        M = label_images.astype(np.uint32)

        import pandas as pd
        frames = []
        for i in range(n_img):
            labs, values = self._runner.run(I[i], M[i])
            values = _force_finite(values, self.cfg.noval)
            frames.append(self._to_frame(intensity_names[i], label_names[i],
                                         labs, values))
        if not frames:
            return self._to_frame("", "", np.zeros(0, np.int64),
                                  np.zeros((0, len(self.header) - 4)))
        return pd.concat(frames, ignore_index=True)

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
