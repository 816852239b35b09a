"""Field arithmetic: Goldilocks on int64 tensors (gl64) and the multi-limb
Montgomery fields on int32 words (bigmont, with the bigmont_ew kernel's
wrappers in kernels)."""

from . import gl64, bigmont, kernels
from .bigmont import BigMontField, get_field_ops

__all__ = ["gl64", "bigmont", "kernels", "BigMontField", "get_field_ops"]
