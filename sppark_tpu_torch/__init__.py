"""sppark_tpu_torch: the PyTorch and CUDA port of sppark_tpu for NVIDIA
Hopper (H100).

It holds the Goldilocks NTT and LDE (ff/gl64.py, ntt/: the row and column
NTT kernels in csrc/ntt_gl64.cu), the wide-field NTT and LDE
(csrc/ntt_wide.cu) and the G1 and G2 Pippenger MSM (ff/bigmont.py,
ff/ext.py, ec/, msm/: the Montgomery multiply in csrc/bigmont.cu and the
xyzz point kernels in csrc/ec_xyzz.cu and csrc/ec_fp2_*.cu), each kernel
beside its plain PyTorch version.
It imports torch and nothing of JAX or sppark_tpu.
"""

from . import params
from .params import get_field, get_curve, FIELDS, CURVES
from .util.errors import SpparkError

__version__ = "0.1.0"

__all__ = ["params", "get_field", "get_curve", "FIELDS", "CURVES",
           "SpparkError", "__version__"]
