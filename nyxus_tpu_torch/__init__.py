"""nyxus_tpu_torch: the PyTorch/CUDA port of nyxus_tpu for NVIDIA Hopper.

Computes engineered intensity and texture features per segmented ROI,
batched over padded ROI tensors on a CUDA device, with the matrix, run and
stencil builders as kernels written by hand for sm_90a (``csrc/``).  The JAX
package ``nyxus_tpu`` is the reference it is held against; this package
imports neither jax nor anything of ``nyxus_tpu``.
"""

from .api import Nyxus
from .config import EngineConfig
from .functions import get_gpu_properties, gpu_is_available

__version__ = "0.1.0"

__all__ = ["Nyxus", "EngineConfig", "gpu_is_available", "get_gpu_properties",
           "__version__"]
