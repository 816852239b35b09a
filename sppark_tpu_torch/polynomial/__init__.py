"""Polynomial kernels (sppark's polynomial/ directory), the port of
sppark_tpu/polynomial: an inclusive prefix scan with add or multiply
(prefix_op.cuh), synthetic division by (x - z) as a reverse scan over
(value, z-power) pairs (div_by_x_minus_z.cuh) and multi-point evaluation
by a powers ladder and a tree sum (evaluate.cuh), over every field family
of the port in its own word layout."""

from .core import (div_by_x_minus_z, evaluate, prefix_op, prefix_product,
                   prefix_sum)

__all__ = ["prefix_op", "prefix_sum", "prefix_product", "div_by_x_minus_z",
           "evaluate"]
