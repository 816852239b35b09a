from . import ntt

__all__ = ["ntt"]
