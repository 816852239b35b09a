"""Pure-Python reference implementations (the oracle): exact big-int field,
G1/G2 curve, NTT and MSM math, with no dependency beyond the parameters."""

from . import ntt
from .field import Fp2, Fr
from .ec import AffinePoint, JacobianPoint, XyzzPoint, curve_generator
from .msm import msm_naive, msm_pippenger
from .ntt import (bit_reverse, coset_intt, coset_ntt, intt_natural, lde,
                  ntt_natural)

__all__ = ["ntt", "Fr", "Fp2", "AffinePoint", "JacobianPoint", "XyzzPoint",
           "curve_generator", "msm_naive", "msm_pippenger", "ntt_natural",
           "intt_natural", "bit_reverse", "coset_ntt", "coset_intt", "lde"]
