"""sppark_tpu_torch: the PyTorch and CUDA port of sppark_tpu for NVIDIA
Hopper (H100).

This slice holds the Goldilocks NTT and LDE: the field on int64 tensors
(ff/gl64.py), twiddle tables (ntt/parameters.py), the row and column NTT
kernels in CUDA C++ (csrc/ntt_gl64.cu, bound in ntt/kernels.py), their
four-step and six-step orchestration (ntt/fused.py) and the facade
(ntt/__init__.py).  It imports torch and nothing of JAX or sppark_tpu.
"""

from . import params
from .params import get_field, FIELDS
from .util.errors import SpparkError

__version__ = "0.1.0"

__all__ = ["params", "get_field", "FIELDS", "SpparkError", "__version__"]
