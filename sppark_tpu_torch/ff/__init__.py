"""Field arithmetic: Goldilocks on int64 tensors (gl64), the 31-bit
fields on int32 words (mont32: BabyBear, Mersenne-31), the multi-limb
Montgomery fields on int32 words (bigmont, with the bigmont_ew kernel's
wrappers in kernels), the extensions (ext: Fp2Field, BabyBear4Field) and
the batch inversions they share (inversion)."""

from . import gl64, mont32, bigmont, ext, inversion, kernels
from .bigmont import BigMontField, get_field_ops
from .ext import BabyBear4Field, Fp2Field, get_fp2_ops
from .mont32 import Mersenne31Field, Mont32Field, get_mont32_ops

__all__ = ["gl64", "mont32", "bigmont", "ext", "inversion", "kernels",
           "BigMontField", "get_field_ops", "Fp2Field", "get_fp2_ops",
           "BabyBear4Field", "Mont32Field", "Mersenne31Field",
           "get_mont32_ops"]
