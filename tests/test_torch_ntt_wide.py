"""The port's wide-field NTT (BLS12-381 Fr, BN254 Fr and the 63-bit
test_bm64_fr) on the CPU, where its kernels take their plain versions:

  (a) the bigmont_ntt_mid plain version against the interpreted
      _apply_mid_factored (kernel 3) on test_bm64_fr;
  (b) the four-step and six-step (caps lowered) against the JAX package's
      fused path, its interpreted wide kernels fed the port's twiddle
      tables carried across with to_jax_planes; (c) holds those tables
      equal to the JAX package's own;
  (c) the power tables and the factored middle twiddles (A, B) against
      the JAX package's, test_bm64_fr and bls12_381_fr;
  (d) one bls12_381_fr four-step transform against the JAX package's
      generic ntt.base, wire arrays in and out;
  (e) orders, coset and the LDE family on bls12_381_fr and bn254_fr
      against the port's big-int oracle.

Words meet through from_jax_planes / to_jax_planes, and every comparison
is exact (integer field arithmetic, tolerance zero).  No 256-bit Pallas
kernel is interpreted: the 16-limb interpreted kernels take many minutes
on the CPU."""

import itertools
import os
import random

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
from sppark_tpu_torch import params
from sppark_tpu_torch.ff.bigmont import (from_jax_planes, get_field_ops,
                                         to_jax_planes)
from sppark_tpu_torch.ntt import fused, kernels as K
from sppark_tpu_torch.ntt.parameters import get_parameters
from sppark_tpu_torch.oracle import ntt as oracle
from sppark_tpu_torch.util.errors import SpparkError

BM = "test_bm64_fr"
CONFIGS = list(itertools.product(["NN", "NR", "RN", "RR"], [0, 1], [0, 1]))


@pytest.fixture(autouse=True, scope="module")
def _pallas_interpret():
    # set only while this module's tests run, as test_pallas_interpret.py
    # does: an import-time env change would leak into every other module
    old = os.environ.get("SPPARK_PALLAS_INTERPRET")
    os.environ["SPPARK_PALLAS_INTERPRET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPPARK_PALLAS_INTERPRET", None)
    else:
        os.environ["SPPARK_PALLAS_INTERPRET"] = old


def _clear_jax_kernels():
    for f in (pk._rows_kernel, pk._cols_kernel, pk._mid_factored_kernel,
              pk._fused_fn, pk.fused_facade_fn, pk._scaled_mid):
        f.cache_clear()


def _words(field, seed, *shape):
    """(n32, *shape) random canonical Montgomery words from numpy."""
    fp = params.get_field(field)
    n32 = fp.n_ref_limbs
    w = np.random.default_rng(seed).integers(
        0, 1 << 32, size=(n32,) + shape, dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(fp.modulus >> (32 * (n32 - 1)))
    return torch.from_numpy(w.view(np.int32))


def _jax(t):
    return jnp.asarray(to_jax_planes(t))


def _port(planes):
    return from_jax_planes(np.asarray(planes))


def _ints(field, n, seed):
    rng = random.Random(seed)
    return [rng.randrange(params.get_field(field).modulus) for _ in range(n)]


# -- (a) kernel 3 --------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((8, 16), 4), ((3, 4, 32), 8)],
                         ids=["n1x16", "batch3"])
def test_mid_plain_vs_pallas(shape, block):
    """x * A[k1, j / block] * B[k1, j mod block], the plain version and the
    wrapper (a CPU tensor) against the interpreted Pallas kernel."""
    n1, m = shape[-2:]
    x = _words(BM, 1, *shape)
    a = _words(BM, 2, n1, m // block)
    b = _words(BM, 3, n1, block)
    want = _port(pk._apply_mid_factored(BM, _jax(x), n1.bit_length() - 1,
                                        (_jax(a), _jax(b))))
    assert torch.equal(K.wide_mid_plain(BM, x, a, b), want)
    assert torch.equal(K.wide_mid(BM, x, a, b), want)


# -- (b) the fused path against the JAX package's -----------------------------

def _staged_full(tw, lg):
    """The JAX kernels' (lg, n) per-position stage twiddles from the port's
    power table (parameters.py:staged_full_table's gather)."""
    i = np.arange(1 << lg)
    idx = np.stack([(i & ((1 << (s - 1)) - 1)) << (lg - s)
                    for s in range(1, lg + 1)])
    return _jax(tw[:, torch.from_numpy(idx)])


def _jax_tables(lg, inverse, top=True):
    """pk._fused_tables's structure, built from the port's tables at the
    JAX package's splits and block widths."""
    pm = get_parameters(BM)
    if lg <= pk._tile_cap(BM):
        return (_staged_full(pm.power_table(lg, inverse), lg),)
    lg1 = pk._split_lg1(lg, BM)
    lg2 = lg - lg1
    block = pk._mid_cols_pb(BM, lg1, 1 << lg2)
    mid = (pm.scaled_middle_twiddle_factored(lg, lg1, block)
           if inverse and top else
           pm.middle_twiddle_factored(lg, inverse, lg1, block))
    head = (_staged_full(pm.power_table(lg1, inverse), lg1),
            tuple(_jax(t) for t in mid))
    if lg2 <= pk._tile_cap(BM):
        return head + (_staged_full(pm.power_table(lg2, inverse), lg2),)
    return head + _jax_tables(lg2, inverse, top=False)


@pytest.fixture
def low_caps(monkeypatch):
    """Both packages' wide caps lowered so the four-step (lg 5) and the
    six-step (lg 7) run at small sizes."""
    monkeypatch.setattr(pk, "LG_TILE_WIDE", 3)
    monkeypatch.setattr(pk, "LG_COL_CAP_WIDE", 2)
    monkeypatch.setattr(fused, "LG_TILE_WIDE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP_WIDE", 2)
    _clear_jax_kernels()
    yield
    _clear_jax_kernels()


@pytest.mark.parametrize("lg", [5, 7])
def test_fused_vs_pallas(lg, low_caps):
    """Forward and inverse.  Above the tile cap pk._fused_core does not
    read its `inverse` flag (the inverse's 1/N is in its scaled middle
    twiddles), so one executable serves both directions, each fed its own
    tables: one XLA compile instead of two."""
    fn = pk._fused_fn(BM, lg, False)
    for inverse in (False, True):
        x = _words(BM, lg + inverse, 1 << lg)
        want = _port(fn(_jax(x), tables=_jax_tables(lg, inverse)))
        got = tntt.base_dev(BM, x, lg,
                            direction=tntt.Direction(int(inverse)))
        assert torch.equal(got, want), inverse


# -- (c) tables ------------------------------------------------------------------

@pytest.mark.parametrize("field,lg,lg1,block,inverse",
                         [(BM, 5, 2, 2, True), ("bls12_381_fr", 3, 1, 2, False)])
def test_tables_vs_jax(field, lg, lg1, block, inverse):
    """Power tables and the factored middle twiddles, one direction each
    (every JAX table build is an XLA compile, 16 limbs for bls12_381_fr)."""
    pm, jpm = get_parameters(field), jax_parameters(field)
    assert torch.equal(pm.power_table(lg, inverse),
                       _port(jpm.power_table(lg, inverse)))
    got = pm.middle_twiddle_factored(lg, inverse, lg1, block)
    want = jpm.middle_twiddle_factored(lg, inverse, lg1, block)
    assert all(torch.equal(g, _port(w)) for g, w in zip(got, want))
    # any block gives the same products: the full matrix's words
    T = pm.middle_twiddle_matrix(lg, False, lg1)
    A, B = pm.middle_twiddle_factored(lg, False, lg1, block)
    ones = get_field_ops(field).ones(T.shape[1:]).contiguous()
    assert torch.equal(K.wide_mid_plain(field, ones, A, B), T)


# -- (d) one 256-bit transform against the JAX package's generic path ---------

def test_bls12_381_four_step_vs_jax(monkeypatch):
    """bls12_381_fr at lg 2 through the port's four-step (caps 1 and 1)
    against the JAX package's generic XLA stages, wire arrays in and out;
    and the port's big-int oracle against the JAX package's there."""
    field, lg = "bls12_381_fr", 2
    monkeypatch.setattr(fused, "LG_TILE_WIDE", 1)
    monkeypatch.setattr(fused, "LG_COL_CAP_WIDE", 1)
    ints = _ints(field, 1 << lg, 3)
    wire = get_field_ops(field).to_wire_np(
        get_field_ops(field).from_int_list(ints))
    want = np.asarray(jntt.base(field, wire, lg), dtype=np.uint32)
    assert np.array_equal(tntt.base(field, wire, lg, device="cpu"), want)
    assert np.array_equal(tntt.ntt(field, wire, lg, device="cpu"), want)
    assert oracle.ntt_natural(params.get_field(field), ints) == \
        joracle.ntt_natural(jparams.get_field(field), ints)
    assert oracle.lde(params.get_field(field), ints, 1) == \
        joracle.lde(jparams.get_field(field), ints, 1)


# -- (e) orders, coset and LDE against the port's oracle -------------------------

def _expect(fp, ints, lg, order, inverse, coset):
    """The facade's output for input `ints` given in `order`'s input
    layout."""
    nat = oracle.bit_reverse(ints, lg) if order[0] == "R" else ints
    y = (oracle.coset_ntt(fp, nat, bool(inverse)) if coset
         else oracle.ntt_natural(fp, nat, bool(inverse)))
    return oracle.bit_reverse(y, lg) if order[1] == "R" else y


@pytest.mark.parametrize("field", ["bls12_381_fr", "bn254_fr"])
@pytest.mark.parametrize("path,lg,caps", [("one-pass", 4, (11, 8)),
                                          ("four-step", 5, (3, 2)),
                                          ("six-step", 6, (2, 2))])
def test_orders_coset_vs_oracle(field, path, lg, caps, monkeypatch):
    """All 16 order x direction x type configurations."""
    monkeypatch.setattr(fused, "LG_TILE_WIDE", caps[0])
    monkeypatch.setattr(fused, "LG_COL_CAP_WIDE", caps[1])
    fp = params.get_field(field)
    F = get_field_ops(field)
    ints = _ints(field, 1 << lg, lg)
    for order, inverse, coset in CONFIGS:
        got = tntt.base_dev(field, F.from_int_list(ints), lg,
                            tntt.InputOutputOrder(order),
                            tntt.Direction(inverse), tntt.Type(coset))
        assert F.to_int_list(got) == _expect(fp, ints, lg, order, inverse,
                                             coset), (order, inverse, coset)


@pytest.mark.parametrize("field", ["bls12_381_fr", "bn254_fr"])
def test_lde_family_vs_oracle(field, monkeypatch):
    """lde (host wire arrays), lde_aux_dev, lde_powers_dev and
    lde_expand_dev at lg 4 blowup 2; the extension also through the
    six-step (caps lowered); a batch of rows transforms row by row."""
    fp = params.get_field(field)
    F = get_field_ops(field)
    lg, blowup = 4, 2
    ints = _ints(field, 1 << lg, 9)
    x = F.from_int_list(ints)
    want = oracle.lde(fp, ints, blowup)
    wire = tntt.lde(field, F.to_wire_np(x), lg, blowup, device="cpu")
    assert wire.shape == (1 << (lg + blowup), fp.n_ref_limbs)
    assert F.to_int_list(F.from_wire_np(wire)) == want
    ext, coeffs = tntt.lde_aux_dev(field, x, lg, blowup)
    assert F.to_int_list(ext) == want
    assert F.to_int_list(coeffs) == oracle.intt_natural(fp, ints)
    g = fp.generator
    for bitrev in (False, True):
        idx = oracle.bit_reverse(list(range(1 << lg)), lg) if bitrev \
            else range(1 << lg)
        got = F.to_int_list(tntt.lde_powers_dev(field, x, lg, bitrev))
        assert got == [v * pow(g, i, fp.modulus) % fp.modulus
                       for v, i in zip(ints, idx)]
    spread = F.to_int_list(tntt.lde_expand_dev(field, x, lg, blowup))
    assert spread == [ints[i >> blowup] if i % (1 << blowup) == 0 else 0
                      for i in range(1 << (lg + blowup))]
    monkeypatch.setattr(fused, "LG_TILE_WIDE", 3)
    monkeypatch.setattr(fused, "LG_COL_CAP_WIDE", 2)
    assert F.to_int_list(tntt.lde_dev(field, x, lg, blowup)) == want
    xb = F.from_int_list(ints + _ints(field, 1 << lg, 10),
                         batch_shape=(2, 1 << lg))
    yb = tntt.base_dev(field, xb, lg)
    for r in range(2):
        assert torch.equal(yb[:, r], tntt.base_dev(field, xb[:, r], lg))


# -- entry and wrapper checks ------------------------------------------------------

def test_wide_domain_checks():
    x = _words("bn254_fr", 0, 8)
    with pytest.raises(SpparkError):
        tntt.base_dev("bn254_fr", _words("bn254_fr", 0, 1), 29)
    with pytest.raises(SpparkError):
        tntt.base_dev("bls12_381_fp", _words("bls12_381_fp", 0, 8), 3)
    with pytest.raises(SpparkError):
        tntt.lde_dev("bn254_fr", x, 3, 26)
    with pytest.raises(ValueError):
        tntt.base_dev("bn254_fr", x, 4)
    with pytest.raises(SpparkError, match="Goldilocks"):
        tntt.base_dev("bn254_fr", x.to(torch.int64), 3)
    with pytest.raises(SpparkError, match="Montgomery"):
        tntt.base_dev("bls12_381_fr", _words(BM, 0, 8), 3)


def test_wide_no_silent_cpu():
    """Host-array entry points of a wide field run on the card unless told
    otherwise: with no card and no device they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wire = get_field_ops("bls12_381_fr").to_wire_np(_words("bls12_381_fr",
                                                           0, 8))
    for fn in (tntt.ntt, tntt.intt, tntt.coset_ntt, tntt.coset_intt):
        with pytest.raises(SpparkError):
            fn("bls12_381_fr", wire, 3)
    with pytest.raises(SpparkError):
        tntt.lde("bls12_381_fr", wire, 3, 1)


@pytest.mark.parametrize("bad", ["lg", "tw", "dtype", "limbs", "device"])
def test_wide_wrappers_check_arguments(bad):
    """Shapes, types and devices are checked before any launch; a tensor
    on a device with no kernel (here "meta") raises, never falls back."""
    field = "bn254_fr"
    x, tw, lg = _words(field, 0, 2, 8), _words(field, 1, 4), 3
    a, b = _words(field, 2, 8, 1), _words(field, 3, 8, 2)
    if bad == "lg":
        lg = 12
    elif bad == "tw":
        tw = _words(field, 1, 3)
    elif bad == "dtype":
        x = x.to(torch.int64)
    elif bad == "limbs":
        x = _words(BM, 0, 2, 8)
    else:
        x, tw, a, b = (t.to("meta") for t in (x, tw, a, b))
    err = SpparkError if bad == "device" else (ValueError, TypeError)
    K.reset_launches()
    with pytest.raises(err):
        K.wide_rows(field, x, tw, lg)
    with pytest.raises(err):
        K.wide_cols(field, x.transpose(-1, -2).contiguous(), tw, lg)
    if bad in ("dtype", "limbs", "device"):
        with pytest.raises(err):
            K.wide_mid(field, x.reshape(x.shape[0], 8, 2), a, b)
    assert K.wide_launches == dict.fromkeys(K.wide_launches, 0)
