"""Pippenger MSM over G1 and G2 (msm/ directory analogue): the slab
accumulator (slab), the segmented-tree accumulator (tree, mode="tree"),
the pipeline, its histogram-round modes ("xyzz", "affine") and the entry
points (pippenger), and the flat batch addition (batch_addition)."""

from .batch_addition import batch_addition
from .pippenger import (MSMContext, MSMRoundStages, MSMSlabStages,
                        MSMTreeStages, demont_scalar_words, mult_pippenger)

__all__ = ["MSMContext", "MSMRoundStages", "MSMSlabStages",
           "MSMTreeStages", "batch_addition", "demont_scalar_words",
           "mult_pippenger"]
