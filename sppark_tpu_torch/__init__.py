"""sppark_tpu_torch: the PyTorch and CUDA port of sppark_tpu for NVIDIA
Hopper (H100).

It holds, each kernel beside its plain PyTorch version:
  * the Goldilocks NTT and LDE (ff/gl64.py, ntt/: the row and column NTT
    kernels in csrc/ntt_gl64.cu);
  * the G1 Pippenger MSM (ff/bigmont.py, ec/, msm/: the Montgomery
    multiply in csrc/bigmont.cu, the xyzz point kernels in
    csrc/ec_xyzz.cu);
  * the wide-field NTT and LDE (the row, column and middle-twiddle
    kernels in csrc/ntt_wide.cu);
  * the G2 MSM (ff/ext.py:Fp2Field, the fp2 xyzz kernels in
    csrc/ec_fp2_*.cu);
  * the segmented-tree MSM (msm/tree.py, mode="tree": the batch-affine
    pair kernels in csrc/ec_pair.cu and csrc/ec_fp2_pair.cu);
  * the 31-bit fields and their NTT and LDE (ff/mont32.py: BabyBear with
    both generators, Mersenne-31; ff/ext.py:BabyBear4Field; the mont32 row
    and column NTT kernels in csrc/ntt_mont32.cu: radix-16 passes in
    registers, csrc/ntt_radix.cuh, over the policy of csrc/mont32.cuh).
It imports torch and nothing of JAX or sppark_tpu.
"""

from . import params
from .params import get_field, get_curve, FIELDS, CURVES
from .util.errors import SpparkError

__version__ = "0.1.0"

__all__ = ["params", "get_field", "get_curve", "FIELDS", "CURVES",
           "SpparkError", "__version__"]
