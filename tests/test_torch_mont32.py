"""The port's 31-bit fields (sppark_tpu_torch.ff.mont32: BabyBear with
both generators in Montgomery form, Mersenne-31 with direct reduction),
the quartic extension BabyBear4Field (ff/ext.py) and the roots of
ff/mont32.py and ff/gl64.py, against the JAX package's on the CPU.

The same words, made with numpy from a seed, go through both packages;
comparison is exact (integer field arithmetic).  JAX elements are uint32
arrays of the same words; they cross with from_wire_np / to_wire_np (a
BabyBear4 element with from_jax / to_jax)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ff import get_jax_field
from sppark_tpu.ff.ext import BabyBear4Field as JaxBabyBear4
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.ff.ext import BabyBear4Field
from sppark_tpu_torch.ff.mont32 import (Mersenne31Field, Mont32Field,
                                        get_mont32_ops)
from sppark_tpu_torch.params import get_field

FIELDS = ["baby_bear", "baby_bear_risc0", "mersenne31"]


def _edge(p):
    return [0, 1, 2, p - 1, p - 2, p // 2, (p + 1) // 2, (1 << 30) - 1]


def _pairs(p, seed, n_random=500):
    """Every pair of edge values, then seeded random pairs."""
    edge = _edge(p)
    rng = np.random.default_rng(seed)
    a = [x for x in edge for _ in edge] + [int(v) for v in
                                           rng.integers(0, p, n_random)]
    b = [y for _ in edge for y in edge] + [int(v) for v in
                                           rng.integers(0, p, n_random)]
    return a, b


def _jax(F, t):
    return jnp.asarray(F.to_wire_np(t))


def _port(F, arr):
    return F.from_wire_np(np.asarray(arr))


def test_field_classes():
    assert type(get_mont32_ops("baby_bear")) is Mont32Field
    assert type(get_mont32_ops("mersenne31")) is Mersenne31Field
    with pytest.raises(ValueError):
        Mont32Field(get_field("goldilocks"))


@pytest.mark.parametrize("op", ["add", "sub", "mul", "sqr", "neg"])
@pytest.mark.parametrize("field", FIELDS)
def test_ops_vs_jax(field, op):
    """The ring ops word for word, and against the big-int result."""
    F, J = get_mont32_ops(field), get_jax_field(field)
    p = F.p
    a, b = _pairs(p, 1)
    ta, tb = F.from_int_list(a), F.from_int_list(b)
    args = (ta, tb) if op in ("add", "sub", "mul") else (ta,)
    got = getattr(F, op)(*args)
    want = getattr(J, op)(*(_jax(F, t) for t in args))
    assert got.dtype == torch.int32
    assert torch.equal(got, _port(F, want))
    ref = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y,
           "mul": lambda x, y: x * y, "sqr": lambda x, y: x * x,
           "neg": lambda x, y: -x}[op]
    assert F.to_int_list(got) == [ref(x, y) % p for x, y in zip(a, b)]


@pytest.mark.parametrize("field", FIELDS)
def test_conversions_vs_jax(field):
    """Int lists, the Montgomery domain and the wire: the JAX package's
    arrays carry across unchanged, words below 2^31 as int32."""
    F, J = get_mont32_ops(field), get_jax_field(field)
    fp = get_field(field)
    vals = _edge(F.p) + [int(v) for v in
                         np.random.default_rng(2).integers(0, F.p, 40)]
    t = F.from_int_list(vals, batch_shape=(4, 12))
    jt = J.from_int_list(vals, batch_shape=(4, 12))
    assert t.shape == (4, 12) and t.dtype == torch.int32
    assert np.array_equal(F.to_wire_np(t), np.asarray(jt))
    assert F.to_int_list(t) == J.to_int_list(jt) == vals
    assert bool((t >= 0).all()) and bool((t < F.p).all())
    assert torch.equal(F.from_wire_np(np.asarray(jt)), t)
    assert torch.equal(F.from_jax(jt), t)
    assert np.array_equal(F.to_jax(t), np.asarray(jt))
    raw = torch.tensor(vals, dtype=torch.int32)
    assert torch.equal(F.to_mont(raw),
                       _port(F, J.to_mont(jnp.asarray(raw.numpy(),
                                                      jnp.uint32))))
    assert torch.equal(F.from_mont(F.to_mont(raw)), raw)
    assert F.to_wire_np(F.ones((3,))).tolist() == [
        fp.one_mont if fp.montgomery_wire else 1] * 3
    assert F.to_int_list(F.const(F.p + 5, (2,))) == [5, 5]


@pytest.mark.parametrize("field", FIELDS)
def test_inversions_vs_jax(field):
    """inv and pow_const, batch_inv with zero lanes, batch_inv_tree on a
    power-of-two axis of non-zero lanes."""
    F, J = get_mont32_ops(field), get_jax_field(field)
    p = F.p
    rng = np.random.default_rng(3)
    vals = _edge(p) + [int(v) for v in rng.integers(1, p, 56)]
    t = F.from_int_list(vals)
    assert torch.equal(F.inv(t), _port(F, J.inv(_jax(F, t))))
    assert F.to_int_list(F.inv(t)) == [pow(v, -1, p) if v else 0
                                       for v in vals]
    assert torch.equal(F.pow_const(t, 12345),
                       _port(F, J.pow_const(_jax(F, t), 12345)))
    assert torch.equal(F.batch_inv(t), _port(F, J.batch_inv(_jax(F, t))))
    nz = F.from_int_list(vals[1:] + [3])
    assert torch.equal(F.batch_inv_tree(nz),
                       _port(F, J.batch_inv_tree(_jax(F, nz))))
    with pytest.raises(ValueError):
        F.batch_inv_tree(t[:6])


@pytest.mark.parametrize("field,k", [("goldilocks", 7), ("baby_bear", 7),
                                     ("baby_bear_risc0", 7),
                                     ("mersenne31", 5)])
def test_nth_root_vs_jax(field, k, rng):
    """tests/test_roots.py's cases: root(x)^k == x, and the JAX package's
    root word for word."""
    p = get_field(field).modulus
    vals = [rng.randrange(1, p) for _ in range(16)]
    J = get_jax_field(field)
    want = J.to_int_list(J.nth_root(J.from_int_list(vals, batch_shape=(16,)),
                                    k))
    if field == "goldilocks":
        root = gl64.nth_root(gl64.from_ints(vals), k)
        assert gl64.to_ints(gl64.pow_const(root, k)) == vals
        assert gl64.to_ints(root) == want
        assert torch.equal({7: gl64.heptaroot, 5: gl64.pentaroot}[k](
            gl64.from_ints(vals)), root)
        return
    F = get_mont32_ops(field)
    root = F.nth_root(F.from_int_list(vals), k)
    assert F.to_int_list(F.pow_const(root, k)) == vals
    assert F.to_int_list(root) == want
    assert torch.equal({7: F.heptaroot, 5: F.pentaroot}[k](
        F.from_int_list(vals)), root)


def test_roots_errors_and_mersenne_sqrt(rng):
    """sqrt on Mersenne-31 gives a root of every square; the errors of
    sppark_tpu/ff/base.py: k sharing a factor with p - 1, sqrt unless p = 3
    (mod 4)."""
    F = get_mont32_ops("mersenne31")
    p = F.p
    vals = [rng.randrange(p) for _ in range(8)]
    squares = [v * v % p for v in vals]
    roots = F.to_int_list(F.sqrt(F.from_int_list(squares)))
    assert [r * r % p for r in roots] == squares
    J = get_jax_field("mersenne31")
    assert roots == J.to_int_list(J.sqrt(J.from_int_list(
        squares, batch_shape=(8,))))
    bb = get_mont32_ops("baby_bear")
    with pytest.raises(ValueError):
        bb.nth_root(bb.zeros((4,)), 3)          # 3 | p - 1 for BabyBear
    with pytest.raises(ValueError):
        gl64.nth_root(gl64.ones((4,)), 3)
    with pytest.raises(NotImplementedError):
        bb.sqrt(bb.ones((4,)))
    with pytest.raises(NotImplementedError):
        gl64.sqrt(gl64.ones((4,)))


def _ext_values(p, n, seed):
    """n seeded 4-tuples; lane 1 is zero, lane 2 is 1, lane 3 has p - 1 in
    every coefficient, lane 4 lies in the base field."""
    rng = np.random.default_rng(seed)
    vals = [tuple(int(v) for v in rng.integers(0, p, 4)) for _ in range(n)]
    vals[1], vals[2], vals[3] = (0, 0, 0, 0), (1, 0, 0, 0), (p - 1,) * 4
    vals[4] = (vals[4][0], 0, 0, 0)
    return vals


def _ext_mul_ref(a, b, beta, p):
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] += a[i] * b[j]
    return tuple((c[k] + beta * (c[k + 4] if k < 3 else 0)) % p
                 for k in range(4))


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "batch_inv",
                                "batch_inv_tree"])
@pytest.mark.parametrize("canonical", [True, False],
                         ids=["beta11", "risc0"])
def test_babybear4_vs_jax(canonical, op):
    """F_p[x]/(x^4 - beta) for beta = 11 and -11, word for word with the
    JAX package; mul against the schoolbook product, inversions against
    a * a^-1 = 1 (zero lanes give zero, batch_inv_tree on non-zero lanes
    only)."""
    E, J = BabyBear4Field(canonical), JaxBabyBear4(canonical)
    p = E.base.p
    vals = _ext_values(p, 16, 4)
    if op == "batch_inv_tree":
        vals[1] = (0, 5, 0, 0)
    a = E.from_int_list(vals)
    b = E.from_int_list(vals[::-1])
    ja = tuple(jnp.asarray(c) for c in E.to_jax(a))
    jb = tuple(jnp.asarray(c) for c in E.to_jax(b))
    args, jargs = ((a, b), (ja, jb)) if op == "mul" else ((a,), (ja,))
    got = getattr(E, op)(*args)
    assert got.shape == (4, 16) and got.dtype == torch.int32
    assert torch.equal(got, E.from_jax(getattr(J, op)(*jargs)))
    got_ints = E.to_int_list(got)
    if op in ("mul", "sqr"):
        other = vals[::-1] if op == "mul" else vals
        assert got_ints == [_ext_mul_ref(x, y, E.beta_int, p)
                            for x, y in zip(vals, other)]
    else:
        for x, y in zip(vals, got_ints):
            want = (0, 0, 0, 0) if not any(x) else (1, 0, 0, 0)
            assert _ext_mul_ref(x, y, E.beta_int, p) == want


def test_babybear4_ring_helpers():
    E = BabyBear4Field()
    p = E.base.p
    vals = _ext_values(p, 8, 5)
    a, b = E.from_int_list(vals), E.from_int_list(vals[::-1])
    assert E.to_int_list(E.add(a, b)) == [
        tuple((x + y) % p for x, y in zip(u, v))
        for u, v in zip(vals, vals[::-1])]
    assert E.to_int_list(E.sub(a, b)) == [
        tuple((x - y) % p for x, y in zip(u, v))
        for u, v in zip(vals, vals[::-1])]
    assert E.to_int_list(E.neg(a)) == [tuple(-x % p for x in u)
                                       for u in vals]
    assert E.is_zero(a).tolist() == [not any(v) for v in vals]
    assert bool(E.eq(a, a).all())
    assert E.to_int_list(E.ones((2,))) == [(1, 0, 0, 0)] * 2
    cond = torch.tensor([True, False] * 4)
    assert torch.equal(E.select(cond, a, b)[:, 1], b[:, 1])
    assert E.to_int_list(E.mul(a, E.inv(a)))[2] == (1, 0, 0, 0)
