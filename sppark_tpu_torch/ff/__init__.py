"""Field arithmetic: Goldilocks on int64 tensors (gl64), the multi-limb
Montgomery fields on int32 words (bigmont, with the bigmont_ew kernel's
wrappers in kernels) and their quadratic extensions (ext: Fp2Field)."""

from . import gl64, bigmont, ext, kernels
from .bigmont import BigMontField, get_field_ops
from .ext import Fp2Field, get_fp2_ops

__all__ = ["gl64", "bigmont", "ext", "kernels", "BigMontField",
           "get_field_ops", "Fp2Field", "get_fp2_ops"]
