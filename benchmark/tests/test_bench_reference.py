"""The plain references against Python ints and against the program's
own plain path on the CPU at tiny sizes."""

import random

import pytest
import torch

from benchmark.core.spec import find_cell
from benchmark.reference import ntt as RN
from benchmark.reference.ec import Curve
from benchmark.reference.field import (PlainField, limbs_from_u32_words,
                                       limbs_from_u64_words)

GL = 0xFFFFFFFF00000001
FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001


@pytest.mark.parametrize("p", [GL, FR])
def test_field_ops_against_ints(p):
    F = PlainField(p)
    rng = random.Random(p & 0xFFFF)
    a = [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(60)]
    b = [p - 1, 0, p - 1, 1] + [rng.randrange(p) for _ in range(60)]
    A, B = F.tensor(a), F.tensor(b)
    assert F.to_ints(F.mul(A, F.tensor([F.mont(v) for v in b]))) == \
        [x * y % p for x, y in zip(a, b)]
    assert F.to_ints(F.add(A, B)) == [(x + y) % p for x, y in zip(a, b)]
    assert F.to_ints(F.sub(A, B)) == [(x - y) % p for x, y in zip(a, b)]
    assert F.to_ints(F.powers(5, 9)) == [F.mont(pow(5, j, p))
                                         for j in range(9)]


@pytest.mark.parametrize("p", [GL, FR])
@pytest.mark.parametrize("lg", [1, 4])
def test_transforms_against_sums(p, lg):
    F, g, n = PlainField(p), 7, 1 << lg
    rng = random.Random(lg)
    x = [rng.randrange(p) for _ in range(n)]
    w = pow(g, (p - 1) >> lg, p)
    X = [sum(x[i] * pow(w, i * k, p) for i in range(n)) % p
         for k in range(n)]
    assert F.to_ints(RN.ntt(F, g, F.tensor(x), lg)) == X
    assert F.to_ints(RN.ntt(F, g, F.tensor(X), lg, inverse=True)) == x
    W = pow(g, (p - 1) >> (lg + 2), p)
    c = [sum(X[i] * pow(w, -i * k, p) for i in range(n)) * pow(n, -1, p)
         % p for k in range(n)]
    want = [sum(c[j] * pow(g * pow(W, k, p), j, p) for j in range(n)) % p
            for k in range(4 * n)]
    assert F.to_ints(RN.lde(F, g, F.tensor(X), lg, 2)) == want


def test_chunked_stages_agree(monkeypatch):
    F = PlainField(FR)
    x = torch.randint(0, 1 << 16, (F.L, 1 << 6), dtype=torch.int64)
    want = RN.ntt(F, 7, x, 6)
    monkeypatch.setattr(RN, "CHUNK_LIMBS", F.L * 4)
    assert torch.equal(RN.ntt(F, 7, x, 6), want)


def _transform_case(name, lg):
    from benchmark.tests.small import SMALL
    cell = find_cell(name)
    load = cell.load(cell.config, {**cell.traffic, **SMALL[name], "lg": lg},
                     99, "cpu")
    load.make_inputs()
    return load


@pytest.mark.parametrize("name,lg", [("goldilocks.ntt", 10),
                                     ("goldilocks.lde", 10),
                                     ("bls12_381.lde_fr", 8)])
def test_transform_reference_equals_the_programs_plain_path(name, lg):
    from sppark_tpu_torch.ntt import fused
    from sppark_tpu_torch.ntt import kernels as K

    load = _transform_case(name, lg)
    field = load.field_name
    for x in load.ring[:2]:
        if load.lg_blowup:
            got = fused.lde(field, x, lg, load.lg_blowup, kern=K.PLAIN)
        else:
            got = fused.facade(field, x, lg, kern=K.PLAIN)
        assert torch.equal(load.limbs(got), load.transform(load.limbs(x)))


@pytest.mark.parametrize("lg_blowup", [0, 2])
def test_transform_kind_takes_31_bit_words(lg_blowup):
    """A 31-bit field's (n,) u32 words, as a configuration with
    word_bytes 4 would give them, against the program's plain path."""
    from benchmark.core.spec import load_kind
    from sppark_tpu_torch.ntt import fused
    from sppark_tpu_torch.ntt import kernels as K
    from sppark_tpu_torch.params import get_field

    f = get_field("baby_bear")
    config = {"program": {"ntt_field": "baby_bear"},
              "ntt_field": {"p": hex(f.modulus), "generator": f.generator,
                            "word_bytes": 4}}
    traffic = {"lg": 8, "lg_blowup": lg_blowup, "ring": 2, "batch": 2}
    load = load_kind("transform")(config, traffic, 7, "cpu")
    load.make_inputs()
    for x in load.ring:
        assert x.shape == (256,) and x.dtype == torch.int32
        got = fused.lde("baby_bear", x, 8, lg_blowup, kern=K.PLAIN) \
            if lg_blowup else fused.facade("baby_bear", x, 8, kern=K.PLAIN)
        assert torch.equal(load.limbs(got), load.transform(load.limbs(x)))


def test_limb_views_of_words():
    w = torch.tensor([-1, 1 << 40, 0x0123456789ABCDEF], dtype=torch.int64)
    assert limbs_from_u64_words(w)[:, 0].tolist() == [0xFFFF] * 4
    assert limbs_from_u64_words(w)[:, 2].tolist() == [0xCDEF, 0x89AB,
                                                      0x4567, 0x0123]
    v = torch.tensor([[-1, 5], [0x12345678, 0]], dtype=torch.int32)
    assert limbs_from_u32_words(v).tolist() == [
        [0xFFFF, 5], [0xFFFF, 0], [0x5678, 0], [0x1234, 0]]


def test_random_points_lie_in_the_torsion():
    cell = find_cell("bls12_381.msm_g1")
    cv = cell.config["curve"]
    C = Curve(int(cv["p"], 0), cv["b"], int(cv["r"], 0),
              int(cv["h_eff"], 0))
    pts = C.random_points(random.Random(1), 3)
    assert all(C.on_curve(q) for q in pts)
    assert all(C.mul((x, y, 1), C.r)[2] == 0 for x, y in pts)


@pytest.mark.parametrize("curve", ["pallas", "bn254"])
def test_random_points_on_other_curves(curve):
    """Square roots for p = 1 mod 4 (Pallas) as for p = 3 mod 4 (BN254)."""
    from sppark_tpu_torch.params import get_curve
    cp = get_curve(curve)
    C = Curve(cp.field.modulus, cp.b, cp.scalar.modulus, 1)
    pts = C.random_points(random.Random(3), 4)
    assert len(set(pts)) == 4 and all(C.on_curve(q) for q in pts)
    assert all(C.mul((x, y, 1), C.r)[2] == 0 for x, y in pts)


def test_tiled_infinity_is_in_every_tile():
    """sppark's util.rs sets base[3] to infinity before tiling: each tile
    of the resident table holds it, and the reference skips its class."""
    cell = find_cell("bls12_381.msm_g1")
    traffic = {**cell.traffic, "lg": 6, "lg_base": 4, "ring": 1}
    load = cell.load(cell.config, traffic, 5, "cpu")
    load.make_inputs()
    assert [i for i, q in enumerate(load.base) if q is None] == [3]
    c = load.class_scalars(load.scalars[0])
    assert len(c) == 16 and c[3] != 0
    assert load.curve.msm(load.base, c) == load.curve.msm(
        [q for i, q in enumerate(load.base) if i != 3],
        [v for i, v in enumerate(c) if i != 3])


def test_config_constants_match_the_program():
    from sppark_tpu_torch.params import get_curve, get_field
    for name in ("bls12_381.msm_g1", "goldilocks.ntt"):
        cfg = find_cell(name).config
        f = get_field(cfg["program"]["ntt_field"])
        assert int(cfg["ntt_field"]["p"], 0) == f.modulus
        assert cfg["ntt_field"]["generator"] == f.generator
    cp = get_curve("bls12_381")
    cv = find_cell("bls12_381.msm_g1").config["curve"]
    assert (int(cv["p"], 0), cv["b"], int(cv["r"], 0)) == \
        (cp.field.modulus, cp.b, cp.scalar.modulus)


@pytest.mark.parametrize("curve", ["test_bm64", "bls12_381"])
def test_reference_msm_equals_the_program(curve):
    """The reference MSM against the program's MSMContext on the CPU (its
    plain path) and its oracle's msm_naive."""
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive
    from sppark_tpu_torch.params import get_curve

    cp = get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(7)
    pts = [o.random_point(rng) for _ in range(16)]
    sc = [rng.randrange(cp.scalar.modulus) for _ in range(16)]
    sc[2], sc[5] = 0, cp.scalar.modulus - 1
    C = Curve(cp.field.modulus, cp.b, cp.scalar.modulus, 1)
    got = C.msm([(q.x, q.y) for q in pts], sc)
    want = msm_naive(cp, pts, sc)
    assert got == (want.x, want.y)
    ctx = MSMContext(curve, 16, wbits=4, device="cpu")
    prog = ctx.invoke(sc, points=pts)
    assert (prog.x, prog.y) == got
