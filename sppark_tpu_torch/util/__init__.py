from .errors import SpparkError

__all__ = ["SpparkError"]
