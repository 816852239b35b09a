"""Field parameters for the NTT fields the port supports.

Every constant is derived from the published definition of the field
(modulus, multiplicative generator): the Goldilocks prime
p = 2^64 - 2^32 + 1 with canonical generator 7, and the Plonky2 variant
with generator 0xc65c18b67785d900 (sppark ntt/parameters/goldilocks.h).
Goldilocks is stored raw, not in Montgomery form, so the wire word is the
canonical u64.
"""

from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Static description of a prime field."""

    name: str
    modulus: int
    #: generator of F_p^*; also the LDE coset generator
    generator: int

    @property
    def two_adicity(self) -> int:
        """s such that 2^s || (p - 1)."""
        t = self.modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        return s

    @functools.lru_cache(maxsize=None)
    def root_of_unity(self, lg_domain: int) -> int:
        """Primitive 2^lg_domain-th root of unity g^((p-1)/2^lg_domain)."""
        if lg_domain > self.two_adicity:
            raise ValueError(f"{self.name}: lg_domain {lg_domain} > "
                             f"two-adicity {self.two_adicity}")
        return pow(self.generator, (self.modulus - 1) >> lg_domain,
                   self.modulus)

    def inv_root_of_unity(self, lg_domain: int) -> int:
        return pow(self.root_of_unity(lg_domain), self.modulus - 2,
                   self.modulus)

    def domain_size_inverse(self, lg_domain: int) -> int:
        """1 / 2^lg_domain mod p."""
        return pow((1 << lg_domain) % self.modulus, self.modulus - 2,
                   self.modulus)


GOLDILOCKS = FieldParams(
    name="goldilocks",
    modulus=(1 << 64) - (1 << 32) + 1,
    generator=7,
)

GOLDILOCKS_PLONKY2 = dataclasses.replace(
    GOLDILOCKS, name="goldilocks_plonky2", generator=0xC65C18B67785D900)

FIELDS = {f.name: f for f in (GOLDILOCKS, GOLDILOCKS_PLONKY2)}


def get_field(name: str) -> FieldParams:
    try:
        return FIELDS[name]
    except KeyError:
        raise KeyError(f"unknown field {name!r}; available: {sorted(FIELDS)}")
