"""Field and curve parameters for the fields and G1/G2 curves the port
supports.

Every constant is derived from the published definition of the field or
curve (modulus, multiplicative generator, curve coefficient, cofactor).

  * The 31-bit fields: BabyBear p = 15 * 2^27 + 1 with its canonical
    generator 31 and the RISC Zero variant with generator 3 (sppark
    ntt/parameters/baby_bear.h), Montgomery form with R = 2^32 on the wire;
    Mersenne-31 p = 2^31 - 1, canonical on the wire, with no NTT (its
    2-adicity is 1).
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
  * The G2 curves y^2 = x^3 + b over F_p^2 = F_p[u]/(u^2 - nr), b = b +
    b_c1 u: BLS12-381 (nr = -1, b = 4 + 4u), BN254 (nr = -1, b = 3 /
    (9 + u)), BLS12-377 (nr = -5, b = 1/u), and test_bm64_g2: y^2 = x^3 + 2
    with nr = 7 over the Goldilocks prime taken as a two-word Montgomery
    field (goldilocks_bm), so its G2 runs the fp2 kernels at N = 2.  Its j = 0 curve has trace t = 2^32 + 1 over F_p (4p =
    L^2 + 27 M^2, L = 2^32 + 1, Deuring), so #E(F_p^2) = (p + 1 - t)(p + 1 +
    t) with p + 1 + t = 467443687 * 39463029637; the 36-bit prime is its
    scalar group, and its coordinates are genuinely quadratic.
  * The test curves over the narrow fields' one-word elements: test_gl64
    (y^2 = x^3 + 10 x + 2 over Goldilocks, a 60-bit prime subgroup),
    test_gl64_g2 (test_bm64_g2's curve on canonical Goldilocks words) and
    toy_bb31 (over BabyBear; its group order is not validated, so no MSM
    result on it is checked).  Their points run the plain point ops on
    every device, as the JAX package sends them through no kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional


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
class Fp2Params:
    """Quadratic extension F_p[u]/(u^2 - nonresidue) of `base`."""

    name: str
    base: FieldParams
    #: u^2 = nonresidue (mod p): -1 for BN254 and BLS12-381, -5 for
    #: BLS12-377, 7 for the test tower
    nonresidue: int

    @property
    def nr_small(self) -> int:
        """The nonresidue as a small signed integer (its representative of
        least absolute value)."""
        p = self.base.modulus
        nr = self.nonresidue % p
        return nr if nr <= p // 2 else nr - p


@dataclasses.dataclass(frozen=True)
class CurveParams:
    """Short Weierstrass curve y^2 = x^3 + a4*x + b over `field` (over its
    quadratic extension `fp2` for G2, where b = b + b_c1 u), with scalar
    field `scalar`; `cofactor` = #E / r is multiplied in when test points
    are sampled, so they lie in the subgroup the scalars act on."""

    name: str
    field: FieldParams
    scalar: FieldParams
    b: int
    a4: int = 0
    cofactor: int = 1
    fp2: Optional[Fp2Params] = None
    b_c1: int = 0

    @property
    def degree(self) -> int:
        """Coefficients per coordinate: 1 for G1, 2 for G2."""
        return 1 if self.fp2 is None else 2


BABY_BEAR = FieldParams(
    name="baby_bear",
    modulus=0x78000001,
    generator=31,
    max_lg_domain=27,
)

BABY_BEAR_RISC0 = dataclasses.replace(BABY_BEAR, name="baby_bear_risc0",
                                      generator=3)

MERSENNE31 = FieldParams(
    name="mersenne31",
    modulus=(1 << 31) - 1,
    generator=7,
    montgomery_wire=False,
    max_lg_domain=0,
)

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

BLS12_377_FP = FieldParams(
    name="bls12_377_fp",
    modulus=0x1AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    generator=15,
)
# the Goldilocks prime as a two-word Montgomery field (the test tower's base)
GOLDILOCKS_BM = FieldParams(name="goldilocks_bm",
                            modulus=(1 << 64) - (1 << 32) + 1, generator=7)
TEST_GL64_G2_FR = FieldParams(
    name="test_gl64_g2_fr",
    modulus=39463029637,
    generator=2,
    montgomery_wire=False,
)

BLS12_377_G1 = CurveParams("bls12_377", BLS12_377_FP, BLS12_377_FR, b=1,
                           cofactor=0x170B5D44300000000000000000000000)

BN254_FP2 = Fp2Params("bn254_fp2", BN254_FP, BN254_FP.modulus - 1)
BLS12_381_FP2 = Fp2Params("bls12_381_fp2", BLS12_381_FP,
                          BLS12_381_FP.modulus - 1)
BLS12_377_FP2 = Fp2Params("bls12_377_fp2", BLS12_377_FP,
                          BLS12_377_FP.modulus - 5)
TEST_BM64_FP2 = Fp2Params("test_bm64_fp2", GOLDILOCKS_BM, 7)

TEST_BM64_G2 = CurveParams(
    "test_bm64_g2", GOLDILOCKS_BM, TEST_GL64_G2_FR, b=2, fp2=TEST_BM64_FP2,
    cofactor=18446744065119617025 * 467443687)
# Toy curve over the BabyBear field: NOT a cryptographic group (its order is
# not validated): it exists so that dry runs can drive the whole MSM
# pipeline on one-word field ops.  Never use it for correctness tests of
# group arithmetic; no MSM result on it is checked.
TOY_BB31_G1 = CurveParams("toy_bb31", BABY_BEAR, BABY_BEAR, b=1)

# A small test curve y^2 = x^3 + 10 x + 2 over the Goldilocks field (its
# canonical u64 words, not the Montgomery words of goldilocks_bm): #E =
# 18446744061260817534 = 2 * 3^2 * r with the 60-bit prime r =
# 1024819114514489863, so the subgroup of order r (cofactor 18) is a real
# prime-order group with two-word scalars, and a4 != 0.
TEST_GL64_FR = FieldParams(
    name="test_gl64_fr",
    modulus=1024819114514489863,
    generator=3,
    montgomery_wire=False,
)
TEST_GL64_G1 = CurveParams("test_gl64", GOLDILOCKS, TEST_GL64_FR, b=2,
                           a4=10, cofactor=18)

# test_bm64_g2's curve, y^2 = x^3 + 2 over F_p^2 = F_p[u]/(u^2 - 7) for
# the Goldilocks p, with the coordinates on the canonical Goldilocks words.
GOLDILOCKS_FP2 = Fp2Params("goldilocks_fp2", GOLDILOCKS, 7)
TEST_GL64_G2 = CurveParams(
    "test_gl64_g2", GOLDILOCKS, TEST_GL64_G2_FR, b=2, fp2=GOLDILOCKS_FP2,
    cofactor=18446744065119617025 * 467443687)

BLS12_381_G2 = CurveParams(
    "bls12_381_g2", BLS12_381_FP, BLS12_381_FR, b=4, b_c1=4,
    fp2=BLS12_381_FP2,
    cofactor=0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5)
# b = 3 / (9 + u) = 3 (9 - u) / 82 with u^2 = -1
_BN_P = BN254_FP.modulus
_BN_82_INV = pow(82, -1, _BN_P)
BN254_G2 = CurveParams(
    "bn254_g2", BN254_FP, BN254_FR, b=27 * _BN_82_INV % _BN_P,
    b_c1=-3 * _BN_82_INV % _BN_P, fp2=BN254_FP2,
    cofactor=21888242871839275222246405745257275088844257914179612981679871602714643921549)
# b = 1 / u
BLS12_377_G2 = CurveParams(
    "bls12_377_g2", BLS12_377_FP, BLS12_377_FR, b=0,
    b_c1=155198655607781456406391640216936120121836107652948796323930557600032281009004493664981332883744016074664192874906,
    fp2=BLS12_377_FP2,
    cofactor=0x26BA558AE9562ADDD88D99A6F6A829FBB36B00E1DCC40C8C505634FAE2E189D693E8C36676BD09A0F3622FBA094800452217CC900000000000000000000001)

FIELDS = {f.name: f for f in (
    BABY_BEAR, BABY_BEAR_RISC0, MERSENNE31, GOLDILOCKS, GOLDILOCKS_PLONKY2,
    BN254_FR, BN254_FP, BLS12_381_FR, BLS12_381_FP, BLS12_377_FR, BLS12_377_FP, PALLAS_P, VESTA_Q,
    TEST_BM64_FP, TEST_BM64_FR, TEST_BM64_FR_SCALAR, GOLDILOCKS_BM,
    TEST_GL64_FR, TEST_GL64_G2_FR)}

CURVES = {c.name: c for c in (
    BN254_G1, BLS12_381_G1, BLS12_377_G1, PALLAS_G1, VESTA_G1,
    TEST_BM64_G1, BLS12_381_G2, BN254_G2, BLS12_377_G2, TEST_BM64_G2,
    TOY_BB31_G1, TEST_GL64_G1, TEST_GL64_G2)}


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
