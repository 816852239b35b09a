"""Error vocabulary: an error with a numeric code and a message, the shape
of sppark's `sppark_error` / `RustError` (util/exception.hpp,
util/rusterror.h)."""

from __future__ import annotations


class SpparkError(RuntimeError):
    """Error with a numeric code, matching the reference's RustError shape."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"sppark error {code}")
        self.code = int(code)
        self.message = message

    def __repr__(self) -> str:
        return f"SpparkError(code={self.code}, message={self.message!r})"


def sppark_ok(cond: bool, code: int, message: str) -> None:
    """Raise SpparkError(code, message) unless `cond` holds: sppark's
    CUDA_OK throw-on-error helper (util/exception.cuh:12-21)."""
    if not cond:
        raise SpparkError(code, message)
