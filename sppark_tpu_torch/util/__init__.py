from .errors import SpparkError, sppark_ok
from .slices import as_u32_view

__all__ = ["SpparkError", "sppark_ok", "as_u32_view"]
