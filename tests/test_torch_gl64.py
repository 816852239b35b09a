"""The port's Goldilocks field (sppark_tpu_torch.ff.gl64) and twiddle tables
(sppark_tpu_torch.ntt.parameters) against the JAX package's, on the CPU.

The same words, made with numpy from a seed, go through both packages;
comparison is exact (integer field arithmetic).  JAX elements are (2, ...)
uint32 planes; they cross with gl64.from_jax_planes / to_jax_planes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ff import get_jax_field
from sppark_tpu.ntt.parameters import get_parameters as jax_parameters
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.ntt.parameters import get_parameters

P = gl64.P
# canonical edge words: 0, 1, p - 1 and both sides of the 2^32 boundaries
EDGE = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        1 << 63, P - (1 << 32), (1 << 63) - 1]
# lazy representatives above p as well
LAZY_EDGE = EDGE + [P, P + 1, (1 << 64) - 1, (1 << 64) - 2,
                    (1 << 64) - (1 << 32)]


def _pairs(edge, rng, n_random, high):
    a = [x for x in edge for _ in edge]
    b = [y for _ in edge for y in edge]
    a += [int(v) for v in rng.integers(0, high, size=n_random,
                                        dtype=np.uint64)]
    b += [int(v) for v in rng.integers(0, high, size=n_random,
                                        dtype=np.uint64)]
    return a, b


def _jax(t):
    return jnp.asarray(gl64.to_jax_planes(t))


def _port(planes):
    return gl64.from_jax_planes(np.asarray(planes))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_ops_vs_jax(op):
    rng = np.random.default_rng(11)
    a, b = _pairs(EDGE, rng, 2000, P)
    ta, tb = gl64.from_ints(a), gl64.from_ints(b)
    F = get_jax_field("goldilocks")
    got = getattr(gl64, op)(ta, tb)
    want = _port(getattr(F, op)(_jax(ta), _jax(tb)))
    assert torch.equal(got, want)
    ref = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P,
           "mul": lambda x, y: x * y % P}[op]
    assert gl64.to_ints(got) == [ref(x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("op", ["add_lazy", "sub_lazy", "mul_lazy"])
def test_lazy_ops_and_canon_vs_jax(op):
    """Lazy ops take any word in [0, 2^64); canon of the result equals the
    JAX package's canon of its own lazy result."""
    rng = np.random.default_rng(12)
    a, b = _pairs(LAZY_EDGE, rng, 2000, 1 << 64)
    ta = torch.tensor([gl64.to_i64(v) for v in a], dtype=torch.int64)
    tb = torch.tensor([gl64.to_i64(v) for v in b], dtype=torch.int64)
    F = get_jax_field("goldilocks")
    got = gl64.canon(getattr(gl64, op)(ta, tb))
    want = _port(F.canon(getattr(F, op)(_jax(ta), _jax(tb))))
    assert torch.equal(got, want)
    ref = {"add_lazy": lambda x, y: (x + y) % P,
           "sub_lazy": lambda x, y: (x - y) % P,
           "mul_lazy": lambda x, y: x * y % P}[op]
    assert gl64.to_ints(got) == [ref(x, y) for x, y in zip(a, b)]


def test_neg_inv_batch_inv_vs_jax():
    rng = np.random.default_rng(13)
    vals = EDGE + [int(v) for v in rng.integers(0, P, size=53,
                                                dtype=np.uint64)]
    t = gl64.from_ints(vals)
    F = get_jax_field("goldilocks")
    assert torch.equal(gl64.neg(t), _port(F.neg(_jax(t))))
    assert torch.equal(gl64.inv(t), _port(F.inv(_jax(t))))
    assert torch.equal(gl64.batch_inv(t), _port(F.batch_inv(_jax(t))))
    assert gl64.to_ints(gl64.inv(t)) == [pow(v, P - 2, P) for v in vals]


def test_wire_and_plane_converters():
    rng = np.random.default_rng(14)
    wire = rng.integers(0, P, size=(3, 37), dtype=np.uint64)
    F = get_jax_field("goldilocks")
    t = gl64.from_wire(wire)
    assert t.dtype == torch.int64 and t.shape == (3, 37)
    assert np.array_equal(gl64.to_wire(t), wire)
    # u32 word pairs are the same wire format
    assert torch.equal(gl64.from_wire(wire.view(np.uint32).reshape(3, 37, 2)),
                       t)
    planes = np.asarray(F.from_wire_np(wire.reshape(-1))).reshape(2, 3, 37)
    assert torch.equal(gl64.from_jax_planes(planes), t)
    assert np.array_equal(gl64.to_jax_planes(t), planes)


@pytest.mark.parametrize("lg", list(range(1, 13)))
def test_power_table_vs_jax(lg):
    pm, jpm = get_parameters("goldilocks"), jax_parameters("goldilocks")
    for inverse in (False, True):
        assert torch.equal(pm.power_table(lg, inverse),
                           _port(jpm.power_table(lg, inverse)))


@pytest.mark.parametrize("lg", [2, 5, 9, 12])
def test_middle_twiddle_matrix_vs_jax(lg):
    pm, jpm = get_parameters("goldilocks"), jax_parameters("goldilocks")
    lg1 = lg // 2
    for inverse in (False, True):
        assert torch.equal(pm.middle_twiddle_matrix(lg, inverse, lg1),
                           _port(jpm.middle_twiddle_matrix(lg, inverse,
                                                           lg1)))


@pytest.mark.parametrize("lg", [1, 4, 8, 12])
def test_coset_powers_vs_jax(lg):
    pm, jpm = get_parameters("goldilocks"), jax_parameters("goldilocks")
    for inverse in (False, True):
        for bitrev in (False, True):
            assert torch.equal(
                pm.coset_powers(lg, inverse, bitrev),
                _port(jpm.coset_powers(lg, inverse, bitrev)))
