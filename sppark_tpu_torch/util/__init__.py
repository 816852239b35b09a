from .errors import SpparkError
from .slices import as_u32_view

__all__ = ["SpparkError", "as_u32_view"]
