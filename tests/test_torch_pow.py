"""The port's fixed-exponent power (sppark_tpu_torch.ff.kernels.mont_pow,
the plain version of the bigmont_pow kernel) and the inversions rewired
through it, on the CPU: against Python's pow, against the JAX package's
pow_const / inv on its generic (XLA) path, and as exact inverses.  Integer
field arithmetic: compared exactly, tolerance zero."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ff import get_jax_field
from sppark_tpu_torch import params
from sppark_tpu_torch.ff import kernels as FK
from sppark_tpu_torch.ff.bigmont import (from_jax_planes, get_field_ops,
                                         to_jax_planes)
from sppark_tpu_torch.ff.ext import get_fp2_ops
from sppark_tpu_torch.util.errors import SpparkError


def _values(p, n, seed):
    """0, 1, p - 1, then seeded canonical ints."""
    rng = random.Random(seed)
    return ([0, 1, p - 1] + [rng.randrange(p) for _ in range(n)])[:n]


def _exponents(p):
    return {"0": 0, "1": 1, "2": 2, "p-2": p - 2, "(p+1)/4": (p + 1) // 4}


@pytest.mark.parametrize("field", ["bn254_fp", "bls12_381_fp"])
@pytest.mark.parametrize("which", ["0", "1", "2", "p-2", "(p+1)/4"])
def test_pow_plain_vs_python(field, which):
    """mont_pow_plain on Montgomery words equals pow(v, e, p) for the
    edge values and seeded ones; e = 0 gives one everywhere, 0 too."""
    fp = params.get_field(field)
    F = get_field_ops(fp)
    p = fp.modulus
    e = _exponents(p)[which]
    vals = _values(p, 6, 1)
    got = FK.mont_pow_plain(F.from_int_list(vals), e, fp)
    assert F.to_int_list(got) == [pow(v, e, p) for v in vals]
    assert torch.equal(got, FK.mont_pow(F.from_int_list(vals), e, fp))


@pytest.mark.parametrize("field", ["test_bm64_fp", "bn254_fp"])
def test_pow_and_inv_vs_jax(field):
    """inv, and pow_const on test_bm64_fp, against the JAX package's (its
    lax.scan chain of XLA products on the CPU: a few lanes never reach a
    Pallas kernel)."""
    F = get_field_ops(field)
    J = get_jax_field(field)
    p = F.p
    x = F.from_int_list(_values(p, 8, 2))
    jx = jnp.asarray(to_jax_planes(x))
    assert torch.equal(F.inv(x), from_jax_planes(J.inv(jx)))
    if field == "test_bm64_fp":     # one more 254-bit chain costs ~2.5 s
        e = random.Random(3).randrange(1 << 64)
        assert torch.equal(F.pow_const(x, e),
                           from_jax_planes(J.pow_const(jx, e)))


@pytest.mark.parametrize("field", ["test_bm64_fp", "bn254_fp"])
def test_inversions_after_rewiring(field):
    """inv, batch_inv and batch_inv_tree, each through ONE pow call, give
    the exact inverses (0 -> 0 where the function allows zero)."""
    calls = []

    def pow_(x, e, fp):
        calls.append(e)
        return FK.mont_pow_plain(x, e, fp)

    F = get_field_ops(field, FK.FieldKernels(
        FK.mont_mul_plain, FK.mont_sqr_plain, pow_, FK.mont_batch_inv_plain))
    p = F.p
    vals = _values(p, 8, 4)
    want = [pow(v, -1, p) if v else 0 for v in vals]
    x = F.from_int_list(vals)
    assert F.to_int_list(F.inv(x)) == want
    assert F.to_int_list(F.batch_inv(x)) == want
    assert F.to_int_list(F.batch_inv_tree(x[:, 1:5])) == want[1:5]
    assert calls == [p - 2] * 3


@pytest.mark.parametrize("curve", ["test_bm64_g2", "bls12_381_g2"])
def test_fp2_batch_inv_tree_exact(curve):
    """Fp2Field.batch_inv_tree on the plain path through the norm: a * a^-1
    is one in every lane."""
    F = get_fp2_ops(params.get_curve(curve).fp2, FK.PLAIN)
    p = F.p
    rng = random.Random(5)
    vals = [(1, 0), (0, 1), (p - 1, 2)] + [(rng.randrange(p),
                                             rng.randrange(1, p))
                                            for _ in range(5)]
    x = F.from_int_list(vals)
    assert F.to_int_list(F.mul(x, F.batch_inv_tree(x))) == [(1, 0)] * 8


def test_pow_wrapper_refusals():
    """The kernel's wrapper refuses a CPU tensor, a foreign dtype, a wrong
    shape, another device and an exponent that does not fit, before any
    nvcc build (this machine has none: a build would raise otherwise)."""
    fp = params.get_field("bls12_381_fp")
    x = get_field_ops(fp).from_int_list([2, 3])
    e = fp.modulus - 2
    with pytest.raises(SpparkError, match="no kernel for device cpu"):
        FK._pow(x, e, fp)
    with pytest.raises(SpparkError, match="no kernel for device meta"):
        FK.mont_pow(x.to("meta"), e, fp)
    with pytest.raises(TypeError, match="int32 words"):
        FK.mont_pow(x.to(torch.int64).to("meta"), e, fp)
    with pytest.raises(ValueError, match="is not \\(12, ...\\) words"):
        FK.mont_pow(x[:8].to("meta"), e, fp)
    for bad in (-1, 1 << 384):
        with pytest.raises(ValueError, match="exponent"):
            FK.mont_pow(x.to("meta"), bad, fp)
    assert np.array_equal(FK._exp_words(e),
                          [(e >> (32 * i)) & 0xFFFFFFFF for i in range(12)])
