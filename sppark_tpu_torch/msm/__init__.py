"""Pippenger MSM over G1 and G2 (msm/ directory analogue): the slab
accumulator (slab), the segmented-tree accumulator (tree, mode="tree") and
the pipeline and entry points (pippenger)."""

from .pippenger import (MSMContext, MSMSlabStages, MSMTreeStages,
                        demont_scalar_words, mult_pippenger)

__all__ = ["MSMContext", "MSMSlabStages", "MSMTreeStages",
           "demont_scalar_words", "mult_pippenger"]
