"""Pippenger MSM over G1 and G2 (msm/ directory analogue): the slab
accumulator (slab) and the pipeline and entry points (pippenger)."""

from .pippenger import (MSMContext, MSMSlabStages, demont_scalar_words,
                        mult_pippenger)

__all__ = ["MSMContext", "MSMSlabStages", "demont_scalar_words",
           "mult_pippenger"]
