"""Big-int reference field arithmetic: the exact math the tensors and
kernels are held against.  Values are plain Python ints in canonical
(non-Montgomery) form; an Fp2 element is a (c0, c1) pair of them."""

from __future__ import annotations

from ..params import FieldParams, Fp2Params


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

    def pow(self, a: int, e: int) -> int:
        return pow(a, e, self.p)

    def to_mont(self, a: int) -> int:
        return self.params.to_mont(a)

    def from_mont(self, a: int) -> int:
        return self.params.from_mont(a)

    def to_wire(self, a: int) -> int:
        """Canonical int -> wire int (Montgomery where the field's wire
        words are Montgomery words)."""
        return self.to_mont(a) if self.params.montgomery_wire else a % self.p

    def from_wire(self, a: int) -> int:
        return self.from_mont(a) if self.params.montgomery_wire else a % self.p

    def rand(self, rng) -> int:
        """A uniform element, one draw of `rng` (a random.Random)."""
        return rng.randrange(self.p)


class Fp2:
    """F_p[u]/(u^2 - nonresidue) on (c0, c1) int pairs, c0 + c1 u."""

    def __init__(self, params: Fp2Params):
        self.params = params
        self.p = params.base.modulus
        self.nr = params.nonresidue % self.p

    def add(self, a, b):
        return ((a[0] + b[0]) % self.p, (a[1] + b[1]) % self.p)

    def sub(self, a, b):
        return ((a[0] - b[0]) % self.p, (a[1] - b[1]) % self.p)

    def neg(self, a):
        return ((-a[0]) % self.p, (-a[1]) % self.p)

    def mul(self, a, b):
        """(a0 + a1 u)(b0 + b1 u) = a0 b0 + nr a1 b1 + (a0 b1 + a1 b0) u;
        a plain int multiplies both coefficients."""
        if isinstance(b, int):
            return (a[0] * b % self.p, a[1] * b % self.p)
        c0 = (a[0] * b[0] + self.nr * a[1] * b[1]) % self.p
        c1 = (a[0] * b[1] + a[1] * b[0]) % self.p
        return (c0, c1)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 - nr a1^2); 0 -> 0."""
        norm = (a[0] * a[0] - self.nr * a[1] * a[1]) % self.p
        if norm == 0:
            return (0, 0)
        ninv = pow(norm, -1, self.p)
        return (a[0] * ninv % self.p, (-a[1]) * ninv % self.p)

    def is_zero(self, a) -> bool:
        return a[0] % self.p == 0 and a[1] % self.p == 0

    def rand(self, rng):
        """A uniform element, c0 drawn from `rng` before c1."""
        return (rng.randrange(self.p), rng.randrange(self.p))
