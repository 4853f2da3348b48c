"""nyxus_tpu_torch: the PyTorch/CUDA port of nyxus_tpu for NVIDIA Hopper.

Computes engineered intensity, texture and shape features per segmented ROI
of 2D images (``Nyxus``) and 3D volumes (``Nyxus3D``), and image-quality
features (``ImageQuality``), batched over padded ROI tensors on a CUDA
device, with the matrix, run, stencil and zone
builders as kernels written by hand for sm_90a (``csrc/``).  The JAX
package ``nyxus_tpu`` is the reference it is held against; this package
imports neither jax nor anything of ``nyxus_tpu``.  ``Nested`` (the
nested-ROI post-pass) needs pandas, which is imported when ``Nested`` is
first read, so ``import nyxus_tpu_torch`` works without it.
"""

from .api import ImageQuality, Nyxus, Nyxus3D
from .config import EngineConfig
from .functions import get_gpu_properties, gpu_is_available

__version__ = "0.1.0"

__all__ = ["Nyxus", "Nyxus3D", "ImageQuality", "Nested", "EngineConfig",
           "gpu_is_available", "get_gpu_properties", "__version__"]


def __getattr__(name):
    if name == "Nested":
        from .nested import Nested
        return Nested
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
