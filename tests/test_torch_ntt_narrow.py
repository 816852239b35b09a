"""The port's NTT over the 31-bit fields (BabyBear, both generators)
against the JAX package's on the CPU, where the port's kernels take their
plain versions: the facade's 16 configurations, the four-step and six-step
(caps lowered), the LDE family, the tables, the plain versions of the
mont32 row and column kernels against the interpreted Pallas
_rows_kernel/_cols_kernel, the refusals and the no-silent-CPU rule.  Words
come from a seeded numpy generator; comparison is exact.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions)."""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu import ntt as jntt
from sppark_tpu import params as jparams
from sppark_tpu.ntt import pallas_kernels as pk
from sppark_tpu.ntt.parameters import get_parameters as jax_parameters
from sppark_tpu.oracle import ntt as joracle
from sppark_tpu_torch import ntt as tntt
from sppark_tpu_torch.ff.mont32 import get_mont32_ops
from sppark_tpu_torch.ntt import fused, kernels as K
from sppark_tpu_torch.ntt.parameters import get_parameters
from sppark_tpu_torch.util.errors import SpparkError

FIELDS = ["baby_bear", "baby_bear_risc0"]
P = jparams.BABY_BEAR.modulus
CONFIGS = list(itertools.product(["NN", "NR", "RN", "RR"], [0, 1], [0, 1]))
F = get_mont32_ops("baby_bear")


def _wire(seed, *shape):
    """Canonical u32 Montgomery words with 0, 1 and p - 1 planted."""
    w = np.random.default_rng(seed).integers(0, P, size=shape,
                                             dtype=np.int64)
    flat = w.reshape(-1)
    flat[:3] = [0, F.params.one_mont, P - 1][:flat.size]
    return w.astype(np.uint32)


def _words(seed, *shape):
    return F.from_wire_np(_wire(seed, *shape))


def _both(field, x, lg, order, direction, coset):
    got = tntt.base(field, x, lg, tntt.InputOutputOrder(order),
                    tntt.Direction(direction), tntt.Type(coset),
                    device="cpu")
    want = jntt.base(field, x, lg, jntt.InputOutputOrder(order),
                     jntt.Direction(direction), jntt.Type(coset))
    return got, np.asarray(want, dtype=np.uint32)


def _ints(words):
    return F.to_int_list(F.from_wire_np(words))


# -- (a) the facade ----------------------------------------------------------------

@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
@pytest.mark.parametrize("field", FIELDS)
def test_facade_vs_jax_all_configs(field, cfg):
    """Every order x direction x type through both packages at lg 3; the
    wire array is u32 in and out."""
    got, want = _both(field, _wire(1, 8), 3, *cfg)
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lg", list(range(1, 11)))
@pytest.mark.parametrize("field", FIELDS)
def test_facade_vs_oracle_by_lg(field, lg):
    """One configuration per lg (cycling through the 16) against the JAX
    package's big-int oracle."""
    fp = jparams.get_field(field)
    x = _wire(lg, 1 << lg)
    order, direction, coset = CONFIGS[(lg * 7 + len(field)) % len(CONFIGS)]
    got = tntt.base(field, x, lg, tntt.InputOutputOrder(order),
                    tntt.Direction(direction), tntt.Type(coset),
                    device="cpu")
    ints = _ints(x)
    if coset:
        xin = joracle.bit_reverse(ints, lg) if order[0] == "R" else ints
        want = joracle.coset_ntt(fp, xin, bool(direction))
        if order[1] == "R":
            want = joracle.bit_reverse(want, lg)
    else:
        want = joracle.apply_order(fp, ints, lg, order, bool(direction))
    assert _ints(got) == want


@pytest.mark.parametrize("cfg", [("NN", 0, 0), ("RN", 1, 1), ("NR", 0, 1),
                                 ("RR", 1, 0)],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_four_step_vs_jax(cfg, monkeypatch):
    """lg > LG_TILE: the column pass with the middle matrix and the
    transposed row pass, through the mont32 wrappers."""
    monkeypatch.setattr(fused, "LG_TILE", 4)
    got, want = _both("baby_bear", _wire(6, 64), 6, *cfg)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("field", FIELDS)
def test_six_step_vs_jax(field, monkeypatch):
    """lg > LG_COL_CAP + LG_TILE: two levels of recursion at lg 9, forward
    and inverse, on a batch of two rows."""
    monkeypatch.setattr(fused, "LG_TILE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP", 2)
    x = _wire(9, 2, 1 << 9)
    for direction in (0, 1):
        got, want = _both(field, x, 9, "NN", direction, 0)
        assert np.array_equal(got, want), direction


def test_lde_family_vs_jax(monkeypatch):
    """lde / lde_aux_dev / lde_powers_dev / lde_expand_dev at lg 6 blowup 2
    on a batch of two columns; the extension also through the six-step
    (caps lowered)."""
    J = jntt
    field, lg, blowup = "baby_bear", 6, 2
    x = _wire(9, 2, 1 << lg)
    want = np.asarray(J.lde(field, x, lg, blowup), dtype=np.uint32)
    assert np.array_equal(tntt.lde(field, x, lg, blowup, device="cpu"), want)
    xd = F.from_wire_np(x)
    ext, coeffs = tntt.lde_aux_dev(field, xd, lg, blowup)
    jext, jcoeffs = J.lde_aux_dev(field, jnp.asarray(x), lg, blowup)
    assert np.array_equal(F.to_wire_np(ext), np.asarray(jext))
    assert np.array_equal(F.to_wire_np(coeffs), np.asarray(jcoeffs))
    for bitrev in (False, True):
        got = tntt.lde_powers_dev(field, xd, lg, bitrev)
        exp = J.lde_powers_dev(field, jnp.asarray(x), lg, bitrev)
        assert np.array_equal(F.to_wire_np(got), np.asarray(exp))
    got = tntt.lde_expand_dev(field, xd, lg, blowup)
    exp = J.lde_expand_dev(field, jnp.asarray(x), lg, blowup)
    assert np.array_equal(F.to_wire_np(got), np.asarray(exp))
    assert _ints(want[1]) == joracle.lde(jparams.BABY_BEAR, _ints(x[1]),
                                         blowup)
    monkeypatch.setattr(fused, "LG_TILE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP", 2)
    assert np.array_equal(tntt.lde(field, x, lg, blowup, device="cpu"), want)


# -- (b) the tables ------------------------------------------------------------------

@pytest.mark.parametrize("field", FIELDS)
def test_tables_vs_jax(field):
    """The power tables, the middle matrix (and its 1/N-scaled inverse
    through the four-step above) and the coset powers."""
    pm, jpm = get_parameters(field), jax_parameters(field)
    for inverse in (False, True):
        for lg in (1, 6):
            assert torch.equal(pm.power_table(lg, inverse),
                               F.from_wire_np(jpm.power_table(lg, inverse)))
        assert torch.equal(pm.middle_twiddle_matrix(9, inverse, 4),
                           F.from_wire_np(jpm.middle_twiddle_matrix(
                               9, inverse, 4)))
        for bitrev in (False, True):
            assert torch.equal(pm.coset_powers(7, inverse, bitrev),
                               F.from_wire_np(jpm.coset_powers(7, inverse,
                                                               bitrev)))
    scaled = pm.scaled_middle_twiddle_matrix(9, 4)
    n_inv = F.const(pm.domain_size_inverse(9), (1, 1))
    assert torch.equal(scaled, F.mul(pm.middle_twiddle_matrix(9, True, 4),
                                     n_inv))


# -- (c) the plain kernels against the interpreted Pallas kernels -------------------

@pytest.fixture(scope="module")
def _pallas_interpret():
    # set only while these tests run, as test_torch_ntt_kernels.py does
    old = os.environ.get("SPPARK_PALLAS_INTERPRET")
    os.environ["SPPARK_PALLAS_INTERPRET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPPARK_PALLAS_INTERPRET", None)
    else:
        os.environ["SPPARK_PALLAS_INTERPRET"] = old


# (lg, shape, rows_pb, inverse, with_mul, out_t, in_rev, out_rev)
ROWS = [
    (5, (8, 32), 8, False, True, False, True, False),
    (4, (2, 4, 16), 4, True, False, True, True, False),
    (5, (8, 32), 4, True, False, False, False, True),
]


@pytest.mark.parametrize("case", ROWS, ids=lambda c: "-".join(map(str, c)))
def test_rows_plain_vs_pallas(case, _pallas_interpret):
    lg, shape, rows_pb, inverse, with_mul, out_t, in_rev, out_rev = case
    x = _words(lg * 10 + rows_pb, *shape)
    mul = _words(lg * 10 + 1, *shape) if with_mul else None
    jpm = jax_parameters("baby_bear")
    fn = pk._rows_kernel("baby_bear", lg, rows_pb, with_mul=with_mul,
                         out_t=out_t, in_rev=in_rev, out_rev=out_rev)
    want = F.from_wire_np(fn(jnp.asarray(F.to_wire_np(x)),
                             jpm.staged_full_table(lg, inverse),
                             None if mul is None
                             else jnp.asarray(F.to_wire_np(mul))))
    tw = get_parameters("baby_bear").power_table(lg, inverse)
    args = (x, tw, lg, mul, in_rev, out_rev, out_t)
    assert torch.equal(K.mont32_rows_plain("baby_bear", *args), want)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(K.mont32_rows("baby_bear", *args), want)


# (lg, shape, cols_pb, inverse, with_mul)
COLS = [
    (5, (32, 8), 8, False, True),
    (3, (2, 8, 8), 4, True, True),
]


@pytest.mark.parametrize("case", COLS, ids=lambda c: "-".join(map(str, c)))
def test_cols_plain_vs_pallas(case, _pallas_interpret):
    lg, shape, cols_pb, inverse, with_mul = case
    x = _words(lg * 10 + cols_pb, *shape)
    mul = _words(lg * 10 + 2, *shape[-2:]) if with_mul else None
    jpm = jax_parameters("baby_bear")
    fn = pk._cols_kernel("baby_bear", lg, cols_pb, with_mul=with_mul)
    want = F.from_wire_np(fn(jnp.asarray(F.to_wire_np(x)),
                             jpm.staged_full_table(lg, inverse),
                             None if mul is None
                             else jnp.asarray(F.to_wire_np(mul))))
    tw = get_parameters("baby_bear").power_table(lg, inverse)
    assert torch.equal(K.mont32_cols_plain("baby_bear", x, tw, lg, mul), want)
    assert torch.equal(K.mont32_cols("baby_bear", x, tw, lg, mul), want)


# -- (d) refusals and the no-silent-CPU rule ---------------------------------------

def test_narrow_refusals():
    """Mersenne-31 has no NTT (its two-adicity is 1 and sppark has none);
    BabyBear's two-adicity is 27; the words are int32."""
    m31 = np.zeros(2, dtype=np.uint32)
    with pytest.raises(SpparkError):
        tntt.base("mersenne31", m31, 1, device="cpu")
    with pytest.raises(SpparkError):
        tntt.base_dev("mersenne31", torch.zeros(2, dtype=torch.int32), 1)
    with pytest.raises(SpparkError):
        tntt.base_dev("baby_bear", torch.zeros(1, dtype=torch.int32), 28)
    with pytest.raises(SpparkError):
        tntt.lde_dev("baby_bear", torch.zeros(8, dtype=torch.int32), 3, 25)
    with pytest.raises(SpparkError, match="int32 words"):
        tntt.base_dev("baby_bear", torch.zeros(8, dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        K.mont32_rows("mersenne31", torch.zeros(1, 4, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        K.mont32_rows("goldilocks", torch.zeros(1, 4, dtype=torch.int32),
                      torch.zeros(2, dtype=torch.int32), 2)


@pytest.mark.parametrize("bad", ["lg", "tw", "dtype", "device", "out_rev"])
def test_mont32_wrappers_check_arguments(bad):
    """Shapes, types and devices are checked before any launch; a tensor
    on a device with no kernel (here "meta") raises, never falls back."""
    x = torch.zeros(2, 8, dtype=torch.int32)
    tw = torch.ones(4, dtype=torch.int32)
    lg, mul = 3, None
    if bad == "lg":
        lg = 4
    elif bad == "tw":
        tw = torch.ones(3, dtype=torch.int32)
    elif bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "device":
        x, tw = x.to("meta"), tw.to("meta")
    err = SpparkError if bad == "device" else (ValueError, TypeError)
    # the device is refused before the kernel's library is built
    match = "no kernel for device" if bad == "device" else None
    with pytest.raises(err, match=match):
        K.mont32_rows("baby_bear", x, tw, lg, x if bad == "out_rev" else mul,
                      out_rev=bad == "out_rev")
    if bad != "out_rev":
        with pytest.raises(err, match=match):
            K.mont32_cols("baby_bear", x.transpose(0, 1).contiguous(), tw,
                          lg)
    assert K.narrow_launches == {"mont32_ntt_rows": 0, "mont32_ntt_cols": 0}


def test_narrow_no_silent_cpu():
    """Host-array entry points run on the card unless told otherwise: with
    no card and no device they raise, they do not fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = _wire(3, 8)
    for fn in (tntt.ntt, tntt.intt, tntt.coset_ntt, tntt.coset_intt):
        with pytest.raises(SpparkError):
            fn("baby_bear", x, 3)
    with pytest.raises(SpparkError):
        tntt.lde("baby_bear_risc0", x, 3, 1)
    K.reset_launches()
    assert K.narrow_launches == {"mont32_ntt_rows": 0, "mont32_ntt_cols": 0}
