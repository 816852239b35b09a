"""Big-int reference field arithmetic: the exact math the tensors and
kernels are held against.  Values are plain Python ints in canonical
(non-Montgomery) form."""

from __future__ import annotations

from ..params import FieldParams


class Fr:
    """Field element helpers bound to a FieldParams (all canonical ints)."""

    def __init__(self, params: FieldParams):
        self.params = params
        self.p = params.modulus

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return a * b % self.p

    def sqr(self, a: int) -> int:
        return a * a % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def inv(self, a: int) -> int:
        """Zero-tolerant inverse: 0 -> 0 (ff/batch_inversion.hpp:18-52)."""
        if a % self.p == 0:
            return 0
        return pow(a, -1, self.p)
