"""Borrowed-view helpers (slice_t / vec2d_t, util/slice_t.hpp:21-44): the
port of sppark_tpu/util/slices.py.

A "slice" is a NumPy view; this reinterprets one as the raw little-endian
u32 words that the FFI layer marshals field elements in.
"""

from __future__ import annotations

import numpy as np


def as_u32_view(buf, expected_words_per_elem: int | None = None
                ) -> np.ndarray:
    """Reinterpret a buffer as a little-endian uint32 array, checking that
    it holds whole elements (Slice<U>'s size-equality asserts,
    rust/src/lib.rs:131-172)."""
    arr = np.asarray(buf)
    view = arr.view(np.uint32) if arr.dtype != np.uint32 else arr
    if expected_words_per_elem is not None and \
            view.size % expected_words_per_elem:
        raise ValueError(
            f"buffer of {view.size} u32 words is not a multiple of "
            f"{expected_words_per_elem} words per element")
    return view
