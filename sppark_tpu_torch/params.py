"""Field and curve parameters for the fields and G1 curves the port supports.

Every constant is derived from the published definition of the field or
curve (modulus, multiplicative generator, curve coefficient, cofactor).

  * Goldilocks p = 2^64 - 2^32 + 1 with canonical generator 7, and the
    Plonky2 variant with generator 0xc65c18b67785d900 (sppark
    ntt/parameters/goldilocks.h).  Stored raw, not in Montgomery form, so
    the wire word is the canonical u64.
  * The multi-limb Montgomery fields (BN254, BLS12-381, Pasta): the wire
    form is Montgomery with R = 2^(32 n), n the reference's count of 32-bit
    limbs (sppark ff/mont_t.cuh: n = ceil(bits / 32), rounded up to even
    from 4 limbs on).
  * The NTT fields carry `max_lg_domain`, sppark's MAX_LG_DOMAIN_SIZE (28
    for the SNARK fields); 0 means the field has no NTT.  test_bm64_fr
    (p = 0x7FFFFFF9 * 2^32 + 1, 63 bits, 2-adicity 32, two 32-bit words)
    runs the wide NTT at 64-bit cost.
  * The G1 curves y^2 = x^3 + a4 x + b over them, and test_bm64: y^2 =
    x^3 + 3 over the prime 2^64 - 59, supersingular (p = 2 mod 3), so
    #E = p + 1 = 2 * 3 * 7 * 439208192231179799; the 59-bit prime
    subgroup is its scalar group.  It keeps MSM tests on the CPU cheap
    (two 32-bit words per coordinate) while being a real prime-order group.
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
    #: True if the wire form is Montgomery (mont_t); False for Goldilocks
    #: and for the scalar fields that only ever carry canonical scalars
    montgomery_wire: bool = True
    #: sppark's largest NTT domain (lg) for the field; 0 = no NTT
    max_lg_domain: int = 0

    @property
    def bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def n_ref_limbs(self) -> int:
        """The reference's count of 32-bit limbs: 1 up to 32 bits, else
        ceil(bits / 32), made even from 4 limbs on (ff/mont_t.cuh:35)."""
        if self.bits <= 32:
            return 1
        n = (self.bits + 31) // 32
        if n >= 4 and n % 2:
            n += 1
        return n

    @property
    def mont_bits(self) -> int:
        """R = 2^mont_bits."""
        return 32 * self.n_ref_limbs

    @property
    def R(self) -> int:
        return 1 << self.mont_bits

    @property
    def RR(self) -> int:
        return self.R * self.R % self.modulus

    @property
    def one_mont(self) -> int:
        return self.R % self.modulus

    def m0(self, word_bits: int) -> int:
        """-p^-1 mod 2^word_bits (the Montgomery M0 constant)."""
        return (-pow(self.modulus, -1, 1 << word_bits)) % (1 << word_bits)

    def to_mont(self, a: int) -> int:
        return a * self.R % self.modulus

    def from_mont(self, a: int) -> int:
        return a * pow(self.R, -1, self.modulus) % self.modulus

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


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """Short Weierstrass G1 curve y^2 = x^3 + a4*x + b over `field`, with
    scalar field `scalar`; `cofactor` = #E / r is multiplied in when test
    points are sampled, so they lie in the subgroup the scalars act on."""

    name: str
    field: FieldParams
    scalar: FieldParams
    b: int
    a4: int = 0
    cofactor: int = 1


GOLDILOCKS = FieldParams(
    name="goldilocks",
    modulus=(1 << 64) - (1 << 32) + 1,
    generator=7,
    montgomery_wire=False,
    max_lg_domain=32,
)

GOLDILOCKS_PLONKY2 = dataclasses.replace(
    GOLDILOCKS, name="goldilocks_plonky2", generator=0xC65C18B67785D900)

BN254_FR = FieldParams(
    name="bn254_fr",
    modulus=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    generator=5,
    max_lg_domain=28,
)

BN254_FP = FieldParams(
    name="bn254_fp",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    generator=3,
)

BLS12_381_FR = FieldParams(
    name="bls12_381_fr",
    modulus=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    generator=7,
    max_lg_domain=28,
)

BLS12_381_FP = FieldParams(
    name="bls12_381_fp",
    modulus=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    generator=2,
)

BLS12_377_FR = FieldParams(
    name="bls12_377_fr",
    modulus=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    generator=22,
    max_lg_domain=28,
)

PALLAS_P = FieldParams(
    # base field of Pallas, scalar field of Vesta
    name="pallas",
    modulus=0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001,
    generator=5,
    max_lg_domain=28,
)

VESTA_Q = FieldParams(
    # base field of Vesta, scalar field of Pallas
    name="vesta",
    modulus=0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001,
    generator=5,
    max_lg_domain=28,
)

TEST_BM64_FP = FieldParams(name="test_bm64_fp", modulus=(1 << 64) - 59,
                           generator=2)
TEST_BM64_FR = FieldParams(name="test_bm64_fr", modulus=0x7FFFFFF900000001,
                           generator=3, max_lg_domain=20)
TEST_BM64_FR_SCALAR = FieldParams(
    name="test_bm64_fr_scalar",
    modulus=439208192231179799,
    generator=3,
    montgomery_wire=False,
)

BN254_G1 = CurveParams("bn254", BN254_FP, BN254_FR, b=3)
BLS12_381_G1 = CurveParams("bls12_381", BLS12_381_FP, BLS12_381_FR, b=4,
                           cofactor=0x396C8C005555E1568C00AAAB0000AAAB)
PALLAS_G1 = CurveParams("pallas", PALLAS_P, VESTA_Q, b=5)
VESTA_G1 = CurveParams("vesta", VESTA_Q, PALLAS_P, b=5)
TEST_BM64_G1 = CurveParams("test_bm64", TEST_BM64_FP, TEST_BM64_FR_SCALAR,
                           b=3, cofactor=42)

FIELDS = {f.name: f for f in (
    GOLDILOCKS, GOLDILOCKS_PLONKY2, BN254_FR, BN254_FP, BLS12_381_FR,
    BLS12_381_FP, BLS12_377_FR, PALLAS_P, VESTA_Q, TEST_BM64_FP,
    TEST_BM64_FR, TEST_BM64_FR_SCALAR)}

CURVES = {c.name: c for c in (
    BN254_G1, BLS12_381_G1, PALLAS_G1, VESTA_G1, TEST_BM64_G1)}


def get_field(name: str) -> FieldParams:
    try:
        return FIELDS[name]
    except KeyError:
        raise KeyError(f"unknown field {name!r}; available: {sorted(FIELDS)}")


def get_curve(name: str) -> CurveParams:
    try:
        return CURVES[name]
    except KeyError:
        raise KeyError(f"unknown curve {name!r}; available: {sorted(CURVES)}")
