"""The port's 3D anisotropy and whole-volume mode against the reference
binary's CSVs, as tests/test_config_parity.py holds the JAX package's:
``ref_3d_aniso_48x56x60_seed4`` (*3D_ALL* at anisotropy 1.4 x 1.2 x 1.5,
3MESH_VOLUME and 3VOLUME_CONVEXHULL left out: the reference's hull is
built from per-plane contours) and ``ref_3d_whole_48x56x60_seed4`` (the
morphology and every texture family of whole-volume mode, which the
binary serves without the intensity family), each column's p90 relative
error within test_config_parity's tiers, with its family exclusions and
its counts of compared columns.  The port runs on the CPU in f64."""

import gzip
import os

import numpy as np
import pandas as pd
import pytest

from test_config_parity import _compare
from test_oversized import _blob3d

from nyxus_tpu_torch import columns as tcol
from nyxus_tpu_torch import taxonomy as ttx
from nyxus_tpu_torch.config import EngineConfig as TConfig
from nyxus_tpu_torch.pipeline.runner3d import VolumeRunner
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
WHOLE_FEATURES = ["*3D_ALL_MORPHOLOGY*", "*3D_GLCM*", "*3D_GLDM*",
                  "*3D_GLDZM*", "*3D_GLRLM*", "*3D_GLSZM*", "*3D_NGLDM*",
                  "*3D_NGTDM*"]
# fixture -> (request, EngineConfig keywords, whole-volume, compared
# columns at least, skipped prefixes), as in tests/test_config_parity.py
CASES = {
    "ref_3d_aniso_48x56x60_seed4": (
        ["*3D_ALL*"], dict(aniso_x=float(np.float32(1.4)),
                           aniso_y=float(np.float32(1.2)),
                           aniso_z=float(np.float32(1.5))), False, 150,
        ("3MESH_VOLUME", "3VOLUME_CONVEXHULL")),
    "ref_3d_whole_48x56x60_seed4": (WHOLE_FEATURES, {}, True, 170, ()),
}


@pytest.mark.parametrize("name", list(CASES))
def test_3d_mode_reference_binary_parity(name):
    features, kw, whole, min_checked, skip = CASES[name]
    ref = pd.read_csv(gzip.open(os.path.join(DATA, name + ".csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = _blob3d(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    if whole:
        labels = np.ones(intens.shape, np.int32)
    fset = ttx.parse_feature_request(features, dim=3)
    cfg = TConfig(precision="f64", **kw)
    labs, values = VolumeRunner(fset, cfg, device="cpu").run(
        intens, labels.astype(np.int32), wholeslide=whole)
    cols = tcol.build_header(fset, cfg)[0][4:]
    ours = pd.DataFrame(values, columns=cols)
    ours["ROI_label"] = labs
    _compare(ref, ours.set_index("ROI_label"), min_checked,
             skip_prefixes=skip)
