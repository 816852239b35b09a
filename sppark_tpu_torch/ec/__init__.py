"""G1 and G2 point arithmetic (ec/ directory analogue): plain branchless
ops in core, the xyzz point kernels' wrappers in kernels."""

from .core import CurveOps, get_curve_ops
from . import kernels

__all__ = ["CurveOps", "get_curve_ops", "kernels"]
