"""The port's multi-limb Montgomery fields (sppark_tpu_torch.ff.bigmont and
the plain versions of the bigmont_ew kernel) against the JAX package's
BigMontField on the CPU: the same words from seeded generators through
both, compared exactly (integer field arithmetic, tolerance zero).  The
port's (n32, ...) int32 words and the JAX package's (L, ...) 16-bit-limb
planes meet through from_jax_planes / to_jax_planes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu import params as jparams
from sppark_tpu.ff import get_jax_field
from sppark_tpu_torch import params as tparams
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import (from_jax_planes, get_field_ops,
                                         to_jax_planes)

FIELDS = ["test_bm64_fp", "pallas", "bls12_381_fp"]


def _values(field, n, seed):
    """Canonical ints: the edge values 0, 1, p - 1, R mod p, then random."""
    fp = tparams.get_field(field)
    rng = random.Random(seed)
    edges = [0, 1, fp.modulus - 1, fp.R % fp.modulus]
    return (edges + [rng.randrange(fp.modulus) for _ in range(n)])[:n]


def _raw_words(field, ints):
    """Ints as (n32, n) words, without a Montgomery conversion."""
    n32 = tparams.get_field(field).n_ref_limbs
    a = np.array([[(v >> (32 * i)) & 0xFFFFFFFF for v in ints]
                  for i in range(n32)], dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32))


def _jax(t):
    return jnp.asarray(to_jax_planes(t))


def _same(t, j):
    return np.array_equal(to_jax_planes(t), np.asarray(j, dtype=np.uint32))


def test_params_match_jax():
    """The port's own copy of the parameters derives the JAX package's
    constants, and the curves are the same."""
    for name in FIELDS + ["bn254_fp", "bn254_fr", "bls12_381_fr", "vesta",
                          "test_bm64_fr_scalar"]:
        t, j = tparams.get_field(name), jparams.get_field(name) \
            if name in jparams.FIELDS else getattr(jparams, name.upper())
        assert (t.modulus, t.n_ref_limbs, t.R, t.RR, t.one_mont, t.m0(32),
                t.montgomery_wire) == (j.modulus, j.n_ref_limbs, j.R, j.RR,
                                       j.one_mont, j.m0(32),
                                       j.montgomery_wire)
    for name in tparams.CURVES:
        t, j = tparams.get_curve(name), jparams.get_curve(name)
        assert (t.field.modulus, t.scalar.modulus, t.b, t.a4, t.cofactor) \
            == (j.field.modulus, j.scalar.modulus, j.b, j.a4, j.cofactor)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("kind", ["mul", "sqr"])
def test_mont_mul_sqr_vs_jax(field, kind):
    """The bigmont_ew plain version against BigMontField.mul / sqr on 64
    lanes of canonical words, edge values meeting edge values."""
    fp = tparams.get_field(field)
    J = get_jax_field(field)
    x = _raw_words(field, _values(field, 64, 1))
    y = _raw_words(field, _values(field, 64, 2)[::-1])
    if kind == "mul":
        got, want = FK.mont_mul(x, y, fp), J.mul(_jax(x), _jax(y))
    else:
        got, want = FK.mont_sqr(x, fp), J.sqr(_jax(x))
    assert _same(got, want)
    assert torch.equal(got, FK.PLAIN.mul(x, x if kind == "sqr" else y, fp))


@pytest.mark.parametrize("field", FIELDS)
def test_ring_ops_vs_jax(field):
    """add / sub / neg / from_mont / to_mont / select on 64 lanes."""
    F = get_field_ops(field)
    J = get_jax_field(field)
    x = _raw_words(field, _values(field, 64, 3))
    y = _raw_words(field, _values(field, 64, 4)[::-1])
    jx, jy = _jax(x), _jax(y)
    assert _same(F.add(x, y), J.add(jx, jy))
    assert _same(F.sub(x, y), J.sub(jx, jy))
    assert _same(F.neg(x), J.neg(jx))
    assert _same(F.from_mont(x), J.from_mont(jx))
    assert _same(F.to_mont(x), J.to_mont(jx))
    cond = torch.arange(64) % 3 == 0
    assert _same(F.select(cond, x, y),
                 J.select(jnp.asarray(cond.numpy()), jx, jy))
    assert np.array_equal(F.is_zero(x).numpy(), np.asarray(J.is_zero(jx)))


@pytest.mark.parametrize("field", FIELDS)
def test_inv_batch_inv_vs_jax(field):
    """The zero-tolerant batch inversion (one Fermat inversion inside) and
    the single inversion against the ints, and on test_bm64_fp against the
    JAX package's words.  A canonical inverse is unique, so equal ints pin
    the words; the wide fields skip the JAX side, whose Fermat chain takes
    10-13 s to trace and run on the CPU."""
    F = get_field_ops(field)
    ints = _values(field, 8, 5)
    x = F.from_int_list(ints)
    got = F.batch_inv(x)
    if field == "test_bm64_fp":
        assert _same(got, get_jax_field(field).batch_inv(_jax(x)))
    p = F.p
    assert F.to_int_list(got) == [pow(v, -1, p) if v % p else 0
                                  for v in ints]
    assert F.to_int_list(F.inv(x[:, 2:4])) == [pow(v, -1, p)
                                               for v in ints[2:4]]


@pytest.mark.parametrize("field", FIELDS)
def test_conversions_vs_jax(field):
    """Int lists, the FFI wire layout and the JAX planes round-trip, and
    agree with the JAX package's converters."""
    F = get_field_ops(field)
    J = get_jax_field(field)
    ints = _values(field, 16, 6)
    x = F.from_int_list(ints)
    assert _same(x, J.from_int_list(ints))
    assert F.to_int_list(x) == J.to_int_list(_jax(x)) == \
        [v % F.p for v in ints]
    wire = F.to_wire_np(x)
    assert wire.shape == (16, F.n32) and wire.dtype == np.uint32
    assert np.array_equal(wire, J.to_wire_np(_jax(x)))
    assert torch.equal(F.from_wire_np(wire), x)
    assert _same(F.from_wire_np(wire), J.from_wire_np(wire))
    planes = to_jax_planes(x)
    assert planes.shape == (2 * F.n32, 16)
    assert torch.equal(from_jax_planes(planes), x)


def test_kernel_wrapper_contract():
    """A CPU tensor takes the plain version; a wrong dtype or shape is
    refused on any device before a kernel could run."""
    fp = tparams.get_field("pallas")
    x = _raw_words("pallas", _values("pallas", 4, 7))
    assert torch.equal(FK.mont_mul(x, x, fp), FK.mont_mul_plain(x, x, fp))
    with pytest.raises(TypeError):
        FK.check_words("bigmont_ew", fp, x.to(torch.int64))
    with pytest.raises(ValueError):
        FK.check_words("bigmont_ew", fp, x[:4])
    consts = FK.field_consts(fp)
    assert consts.shape == (3 * fp.n_ref_limbs + 2,)
    assert int(consts[-2]) * fp.modulus % (1 << 32) == (1 << 32) - 1
    # the fp2 nonresidue, a small signed integer in two's complement
    assert int(consts[-1]) == 0
    assert int(FK.field_consts(fp, nr=-5)[-1]) == (1 << 32) - 5
    with pytest.raises(ValueError):
        FK.field_consts(fp, nr=16)


def test_ntt_refuses_wide_fields():
    """The port's NTT runs on the Goldilocks fields only; a multi-limb field
    now known to `params` is refused, not computed with gl64 arithmetic."""
    from sppark_tpu_torch import ntt
    from sppark_tpu_torch.util.errors import SpparkError

    with pytest.raises(SpparkError, match="Goldilocks"):
        ntt.base_dev("bls12_381_fr", torch.zeros(8, dtype=torch.int64), 3)
