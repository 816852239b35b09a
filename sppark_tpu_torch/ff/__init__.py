"""Field arithmetic: Goldilocks on int64 tensors."""

from . import gl64

__all__ = ["gl64"]
