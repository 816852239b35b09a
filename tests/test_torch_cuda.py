"""The CUDA kernels of sppark_tpu_torch on the card: each held against its
plain version on the same words, and the facade against the big-int
oracle.  Marked `cuda`; each test skips where no CUDA device is present.
This file imports neither JAX nor sppark_tpu, so it runs where those are
not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from sppark_tpu_torch import params
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch import ntt
from sppark_tpu_torch.ntt import fused, kernels as K
from sppark_tpu_torch.ntt.parameters import get_parameters
from sppark_tpu_torch.oracle import ntt as oracle

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _raw(rng, dev, *shape):
    """Any 64-bit words: 0, p - 1, p, p + 1 and 2^64 - 1 in the first lanes
    and 2^64 - 1 in a whole warp's lanes."""
    p, top = params.GOLDILOCKS.modulus, (1 << 64) - 1
    w = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    flat = w.reshape(-1)
    edges = [0, p - 1, p, p + 1, top]
    flat[:len(edges)] = edges[:flat.size]
    flat[32:64] = top
    return gl64.from_wire(w, dev)


@pytest.mark.parametrize("lg", range(1, 14))
def test_rows_kernel_vs_plain(dev, lg):
    """Every lg, so every split of the radix passes; row counts that are
    not a multiple of the rows a block holds (7, 37); out_t with OB > 1 and
    B = 5, neither a power of two nor a multiple of a run of rows (the
    store's general path), and B = 64 (its runs of rows)."""
    rng = np.random.default_rng(lg)
    n = 1 << lg
    tw = get_parameters("goldilocks", dev).power_table(lg, False)
    shapes = [(2, 5, n), (7, n), (37, n), (3, 64, n)]
    before = K.launches["gl64_ntt_rows"]
    for shape in shapes:
        x, mul = _raw(rng, dev, *shape), _raw(rng, dev, *shape)
        for in_rev in (False, True):
            for out_rev in (False, True):
                for out_t in (False, True):
                    for m in ((None,) if out_rev else (None, mul)):
                        args = (x, tw, lg, m, in_rev, out_rev, out_t)
                        got = K.ntt_rows(*args)
                        torch.cuda.synchronize()
                        assert torch.equal(got, K.ntt_rows_plain(*args)), \
                            (shape, args[3] is not None, *args[4:])
    assert K.launches["gl64_ntt_rows"] == before + 12 * len(shapes)


@pytest.mark.parametrize("lg", range(1, 14))
def test_cols_kernel_vs_plain(dev, lg):
    """Every lg, column counts from 1 to 64 (fewer than a block's columns
    included) and 8192, batched and not, with and without the matrix."""
    rng = np.random.default_rng(lg)
    tw = get_parameters("goldilocks", dev).power_table(lg, True)
    for m_cols in (1, 2, 4, 8, 64, 8192):
        x = _raw(rng, dev, 3, 1 << lg, m_cols)
        mid = _raw(rng, dev, 1 << lg, m_cols)
        for xx in (x, x[0].contiguous()):
            for m in (None, mid):
                got = K.ntt_cols(xx, tw, lg, m)
                torch.cuda.synchronize()
                assert torch.equal(got, K.ntt_cols_plain(xx, tw, lg, m)), \
                    (m_cols, tuple(xx.shape), m is not None)


@pytest.mark.parametrize("lg", [5, 14, 20])
def test_facade_on_card(dev, lg):
    """Kernels vs the plain path for every configuration, and the oracle
    for the natural forward transform where it is quick."""
    fp = params.GOLDILOCKS
    wire = np.random.default_rng(lg).integers(0, fp.modulus, size=1 << lg,
                                              dtype=np.uint64)
    x = gl64.from_wire(wire, dev)
    for order in ntt.InputOutputOrder:
        for inverse in (False, True):
            for coset in (False, True):
                got = ntt.base_dev("goldilocks", x, lg, order,
                                   ntt.Direction(int(inverse)),
                                   ntt.Type(int(coset)))
                want = fused.facade("goldilocks", x, lg, order.value,
                                    inverse, coset, kern=K.PLAIN)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (order, inverse, coset)
    if lg <= 14:
        ints = [int(v) for v in wire]
        assert gl64.to_ints(ntt.base_dev("goldilocks", x, lg)) == \
            oracle.ntt_natural(fp, ints)


# -- the 31-bit (mont32) NTT kernels ------------------------------------------------

def _mont32_words(rng, dev, *shape):
    """Canonical BabyBear words with 0, 1 (Montgomery) and p - 1 in the
    first lanes and p - 1 in a whole warp's lanes."""
    fp = params.BABY_BEAR
    w = rng.integers(0, fp.modulus, size=shape, dtype=np.int64)
    flat = w.reshape(-1)
    flat[:3] = [0, fp.one_mont, fp.modulus - 1][:flat.size]
    flat[32:64] = fp.modulus - 1
    return torch.from_numpy(w.astype(np.int32)).to(dev)


@pytest.mark.parametrize("field", ["baby_bear", "baby_bear_risc0"])
@pytest.mark.parametrize("lg", range(1, 14))
def test_mont32_rows_kernel_vs_plain(dev, field, lg):
    """Every lg, so every split of the radix passes; a row count that is
    not a multiple of the rows a block holds (7, 37); out_t with OB > 1 and
    B = 5, neither a power of two nor a multiple of a block's rows (the
    store's general path) and B = 64 (its runs of rows)."""
    rng = np.random.default_rng(lg)
    n = 1 << lg
    tw = get_parameters(field, dev).power_table(lg, False)
    shapes = [(2, 5, n), (7, n), (37, n), (3, 64, n)]
    before = K.narrow_launches["mont32_ntt_rows"]
    for shape in shapes:
        x = _mont32_words(rng, dev, *shape)
        mul = _mont32_words(rng, dev, *shape)
        for in_rev in (False, True):
            for out_rev in (False, True):
                for out_t in (False, True):
                    for m in ((None,) if out_rev else (None, mul)):
                        args = (x, tw, lg, m, in_rev, out_rev, out_t)
                        got = K.mont32_rows(field, *args)
                        torch.cuda.synchronize()
                        assert torch.equal(
                            got, K.mont32_rows_plain(field, *args)), \
                            (shape, args[3] is not None, *args[4:])
    assert K.narrow_launches["mont32_ntt_rows"] == before + 12 * len(shapes)


@pytest.mark.parametrize("field", ["baby_bear", "baby_bear_risc0"])
@pytest.mark.parametrize("lg", range(1, 12))
def test_mont32_cols_kernel_vs_plain(dev, field, lg):
    """Every lg, column counts from 1 to 64 (fewer than a block's 8 or 16
    columns included), batched and not, with and without the matrix."""
    rng = np.random.default_rng(lg)
    tw = get_parameters(field, dev).power_table(lg, True)
    for m_cols in (1, 2, 4, 8, 64):
        x = _mont32_words(rng, dev, 3, 1 << lg, m_cols)
        mid = _mont32_words(rng, dev, 1 << lg, m_cols)
        for xx in (x, x[0].contiguous()):
            for m in (None, mid):
                got = K.mont32_cols(field, xx, tw, lg, m)
                torch.cuda.synchronize()
                assert torch.equal(got, K.mont32_cols_plain(field, xx, tw,
                                                            lg, m)), \
                    (m_cols, tuple(xx.shape), m is not None)


def test_baby_bear_facade_on_card(dev):
    """BabyBear 2^16 (the four-step: both mont32 kernels) against the
    plain facade on the card for every configuration, and the natural
    forward transform against the big-int oracle."""
    from sppark_tpu_torch.ff.mont32 import get_mont32_ops

    field, lg = "baby_bear", 16
    F = get_mont32_ops(field)
    x = _mont32_words(np.random.default_rng(16), dev, 1 << lg)
    K.reset_launches()
    y = ntt.base_dev(field, x, lg)
    torch.cuda.synchronize()
    assert all(v > 0 for v in K.narrow_launches.values())
    assert F.to_int_list(y) == oracle.ntt_natural(params.BABY_BEAR,
                                                  F.to_int_list(x))
    for order in ntt.InputOutputOrder:
        for inverse in (False, True):
            for coset in (False, True):
                got = ntt.base_dev(field, x, lg, order,
                                   ntt.Direction(int(inverse)),
                                   ntt.Type(int(coset)))
                want = fused.facade(field, x, lg, order.value, inverse,
                                    coset, kern=K.PLAIN)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (order, inverse, coset)


# -- the wide-field NTT kernels ---------------------------------------------------

#: n32 = 2 (test_bm64_fr: one carry chain, no spare bit) and 8 (BN254,
#: BLS12-381, BLS12-377, Pallas: the split chains, p < 2^255)
WIDE_FIELDS = ["test_bm64_fr", "bn254_fr", "bls12_381_fr", "bls12_377_fr",
               "pallas"]


def _wide_words(field, rng, dev, *shape):
    """(n32, *shape) random canonical Montgomery words, with the words 0,
    1, p - 1 and p - 2 planted at elements 0, 1, 2, 3 and at the last four
    (every word near its top at the end: the carry chains' edge)."""
    from sppark_tpu_torch.ff.kernels import int_words

    fp = params.get_field(field)
    n32 = fp.n_ref_limbs
    w = rng.integers(0, 1 << 32, size=(n32,) + shape,
                     dtype=np.uint64).astype(np.uint32)
    w[-1] %= np.uint32(fp.modulus >> (32 * (n32 - 1)))
    flat = w.reshape(n32, -1)
    edges = [int_words(v, n32) for v in (0, 1, fp.modulus - 1,
                                         fp.modulus - 2)]
    for k, e in enumerate(edges):
        flat[:, k % flat.shape[1]] = e
        flat[:, -1 - k] = e
    return torch.from_numpy(w.view(np.int32)).to(dev)


@pytest.mark.parametrize("field", WIDE_FIELDS)
def test_wide_rows_kernel_vs_plain(dev, field):
    rng = np.random.default_rng(3)
    for lg in (1, 6, 11):
        tw = get_parameters(field, dev).power_table(lg, False)
        x = _wide_words(field, rng, dev, 2, 3, 1 << lg)
        mul = _wide_words(field, rng, dev, 2, 3, 1 << lg)
        before = K.wide_launches["bigmont_ntt_rows"]
        for in_rev in (False, True):
            for out_rev in (False, True):
                for out_t in (False, True):
                    for m in ((None,) if out_rev else (None, mul)):
                        args = (x, tw, lg, m, in_rev, out_rev, out_t)
                        got = K.wide_rows(field, *args)
                        torch.cuda.synchronize()
                        assert torch.equal(
                            got, K.wide_rows_plain(field, *args)), args[3:]
        assert K.wide_launches["bigmont_ntt_rows"] == before + 12


@pytest.mark.parametrize("field", WIDE_FIELDS)
def test_wide_cols_and_mid_kernels_vs_plain(dev, field):
    rng = np.random.default_rng(4)
    for lg in (1, 8, 11):
        tw = get_parameters(field, dev).power_table(lg, True)
        x = _wide_words(field, rng, dev, 3, 1 << lg, 16)
        a = _wide_words(field, rng, dev, 1 << lg, 4)
        b = _wide_words(field, rng, dev, 1 << lg, 4)
        for xx in (x, x[:, 0].contiguous()):
            got = K.wide_cols(field, xx, tw, lg)
            torch.cuda.synchronize()
            assert torch.equal(got, K.wide_cols_plain(field, xx, tw, lg))
        for xx in (x, x[:, 0].contiguous()):
            got = K.wide_mid(field, xx, a, b)
            torch.cuda.synchronize()
            assert torch.equal(got, K.wide_mid_plain(field, xx, a, b))


def test_wide_launch_refuses_p_without_spare_bit(dev):
    """The row and column passes' carry-chain element needs p < 2^255 at
    n32 = 8: constants of p = 2^256 - 189 (prime, top bit set) are refused
    at the C entry point with cudaErrorInvalidValue, where BN254's launch."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.kernels import int_words

    p = (1 << 256) - 189
    bad = np.asarray(int_words(p, 8) + int_words((1 << 256) % p, 8)
                     + [0] * 8 + [-pow(p, -1, 1 << 32) % (1 << 32), 0],
                     dtype=np.uint32)
    good = FK.field_consts(params.get_field("bn254_fr"))
    rng = np.random.default_rng(5)
    lg = 4
    tw = get_parameters("bn254_fr", dev).power_table(lg, False)
    x = _wide_words("bn254_fr", rng, dev, 4, 1 << lg)
    out = torch.empty_like(x)
    lib = K._wide_lib()
    stream = torch.cuda.current_stream().cuda_stream
    for consts, rc in ((bad, 1), (good, 0)):
        assert lib.bigmont_ntt_rows(8, x.data_ptr(), tw.data_ptr(), None,
                                    out.data_ptr(), 1, 4, lg, 1, 0, 0,
                                    consts.ctypes.data, stream) == rc
        assert lib.bigmont_ntt_cols(8, x.data_ptr(), tw.data_ptr(),
                                    out.data_ptr(), 1, lg, 4,
                                    consts.ctypes.data, stream) == rc
    torch.cuda.synchronize()


def test_wide_facade_on_card(dev):
    """bls12_381_fr 2^16 through base_dev (the four-step: every wide kernel
    launched) against the big-int oracle, and the inverse round trip."""
    import random
    from sppark_tpu_torch.ff.bigmont import get_field_ops

    field, lg = "bls12_381_fr", 16
    fp, F = params.get_field(field), get_field_ops(field)
    rng = random.Random(16)
    ints = [rng.randrange(fp.modulus) for _ in range(1 << lg)]
    x = F.from_int_list(ints, device=dev)
    K.reset_launches()
    y = ntt.base_dev(field, x, lg)
    torch.cuda.synchronize()
    assert all(v > 0 for v in K.wide_launches.values())
    assert F.to_int_list(y) == oracle.ntt_natural(fp, ints)
    back = ntt.base_dev(field, y, lg, direction=ntt.Direction.inverse)
    torch.cuda.synchronize()
    assert torch.equal(back, x)


# -- the MSM kernels -------------------------------------------------------------

def _canon_words(F, n, seed, dev):
    """(n32, n) random canonical words, edge values 0, 1, p - 1 and
    R mod p in the first lanes."""
    from sppark_tpu_torch.ff.kernels import int_words
    w = np.random.default_rng(seed).integers(0, 1 << 32, size=(F.n32, n),
                                             dtype=np.uint64)
    w = w.astype(np.uint32)
    w[-1] %= np.uint32(F.p >> (32 * (F.n32 - 1)))
    for k, v in enumerate([0, 1, F.p - 1, F.params.R % F.p]):
        w[:, k] = int_words(v, F.n32)
    return torch.from_numpy(w.view(np.int32)).to(dev)


def _point_cases(curve, n, dev):
    """xyzz p (ZZ != 1), affine a, xyzz q (a rescaled).  Lanes 0..31 are
    generic (a warp with no doubling lane); lane 33 doubles, 34 cancels,
    35 has a and q at infinity, 36 an empty bucket, 37 both, 38 Y == 0."""
    import random
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.oracle.ec import get_oracle

    o = get_oracle(params.get_curve(curve))
    ops = get_curve_ops(curve, FK.PLAIN)
    F = ops.F
    rng = random.Random(9)
    pool = [o.random_point(rng) for _ in range(8)]
    j = [rng.randrange(8) for _ in range(n)]
    aff = [pool[(j[i] + 1 + rng.randrange(7)) % 8] for i in range(n)]
    twice = lambda P: o.jacobian_to_affine(                # noqa: E731
        o.jacobian_dbl(o.to_jacobian(P)))
    aff[33] = twice(pool[j[33]])
    aff[34] = o.affine_neg(twice(pool[j[34]]))
    aff[35] = aff[37] = o.infinity_affine()
    p = tuple(c.clone() for c in ops.xyzz_dbl(ops.affine_to_xyzz(
        ops.affine_from_ints([pool[k] for k in j], dev))))
    for c in p:
        c[:, 36:38] = 0
    p[1][:, 38] = 0
    a = ops.affine_from_ints(aff, dev)
    if ops.degree == 1:
        lam = [rng.randrange(1, F.p) for _ in range(n)]
    else:
        lam = [(rng.randrange(F.p), rng.randrange(1, F.p)) for _ in range(n)]
    lam = F.from_int_list(lam, device=dev)
    l2 = F.sqr(lam)
    l3 = F.mul(l2, lam)
    q = ops._sel(ops.affine_is_inf(a), ops.xyzz_infinity((n,), dev),
                 (F.mul(a[0], l2), F.mul(a[1], l3), l2, l3))
    return p, a, q


MSM_CURVES = ["test_bm64", "pallas", "bls12_381"]


@pytest.mark.parametrize("curve", MSM_CURVES)
def test_mont_kernel_vs_plain(dev, curve):
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops

    fp = params.get_curve(curve).field
    F = get_field_ops(fp)
    x = _canon_words(F, 1000, 1, dev)
    y = _canon_words(F, 1000, 2, dev).flip(1).contiguous()
    before = FK.launches["bigmont_ew"]
    got = FK.mont_mul(x, y, fp), FK.mont_sqr(x, fp)
    torch.cuda.synchronize()
    assert torch.equal(got[0], FK.mont_mul_plain(x, y, fp))
    assert torch.equal(got[1], FK.mont_sqr_plain(x, fp))
    assert FK.launches["bigmont_ew"] == before + 2


@pytest.mark.parametrize("field", ["test_bm64_fp", "bn254_fp",
                                   "bls12_381_fp"])      # n32 = 2, 8, 12
def test_pow_kernel_vs_plain(dev, field):
    """bigmont_pow against mont_pow_plain at 1, 31, 32, 33 and 2^16 lanes
    (prefixes of one input with 0, 1, p - 1 and R mod p planted) for e = 0,
    1, 2, p - 2 and (p + 1) / 4: one launch each."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops

    fp = params.get_field(field)
    x = _canon_words(get_field_ops(fp), 1 << 16, 3, dev)
    p = fp.modulus
    for e in (0, 1, 2, p - 2, (p + 1) // 4):
        want = FK.mont_pow_plain(x, e, fp)
        for n in (1, 31, 32, 33, 1 << 16):
            before = FK.launches["bigmont_pow"]
            got = FK.mont_pow(x[:, :n], e, fp)
            torch.cuda.synchronize()
            assert torch.equal(got, want[:, :n]), (e, n)
            assert FK.launches["bigmont_pow"] == before + 1


INV_LANES = [1, 31, 256 * 16 - 1, 256 * 16 + 1, (1 << 20) + 3]


def _inv_inputs(F, seed, dev, degree=1):
    """Prefixes of one (degree n32, 2^20 + 3) input of canonical words, one
    for each of INV_LANES, with zero lanes planted at 0, 30, 4094, 4096
    and 1 << 20 and, in degree 2, a (0, c1) lane at 3 and a (c0, 0) lane
    at 5."""
    n = INV_LANES[-1]
    x = torch.cat([_canon_words(F, n, seed + k, dev) for k in range(degree)])
    x[:, [0, 30, 4094, 4096, 1 << 20]] = 0
    if degree == 2:
        x[:F.n32, 3] = 0
        x[F.n32:, 5] = 0
    return [x[:, :k].contiguous() for k in INV_LANES]


@pytest.mark.parametrize("field", ["test_bm64_fp", "bn254_fp",
                                   "bls12_381_fp"])     # n32 = 2, 8, 12
def test_batch_inv_kernels_vs_plain(dev, field):
    """bigmont_inv_up -> bigmont_pow -> bigmont_inv_down against the plain
    pipeline at 1, 31, T C - 1, T C + 1 and 2^20 + 3 lanes with zero lanes
    planted: the up kernel's arrays and the inverses word for word, three
    launches a call."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops

    assert FK.INV_THREADS * FK.INV_CHUNK == 256 * 16
    fp = params.get_field(field)
    for x in _inv_inputs(get_field_ops(fp), 1, dev):
        n = x.shape[1]
        for got, want in zip(FK.inv_up(x, fp), FK.inv_up_plain(x, fp)):
            torch.cuda.synchronize()
            assert (got is None and want is None) or torch.equal(got, want)
        before = dict(FK.launches)
        got = FK.mont_batch_inv(x, fp)
        torch.cuda.synchronize()
        assert {k: FK.launches[k] - before[k] for k in before} == {
            "bigmont_ew": 0, "bigmont_pow": 1, "bigmont_inv_up": 1,
            "bigmont_inv_down": 1}
        assert torch.equal(got, FK.mont_batch_inv_plain(x, fp)), n


@pytest.mark.parametrize("curve", ["bls12_381_g2", "bn254_g2",
                                   "bls12_377_g2"])     # nr -1, -1, -5
def test_fp2_batch_inv_kernels_vs_plain(dev, curve):
    """Degree 2 (the norm in the up kernel, the conjugate multiply in the
    down kernel) against the plain pipeline, with zero, (0, c1) and (c0,
    0) lanes; a * a^-1 is one on every non-zero lane."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.ext import get_fp2_ops

    F = get_fp2_ops(params.get_curve(curve).fp2)
    fp, nr = F.base.params, F.nr
    for x in _inv_inputs(F.base, 7, dev, degree=2):
        n = x.shape[1]
        for got, want in zip(FK.inv_up(x, fp, 2, nr),
                             FK.inv_up_plain(x, fp, 2, nr)):
            torch.cuda.synchronize()
            assert torch.equal(got, want), n
        got = FK.mont_batch_inv(x, fp, 2, nr)
        torch.cuda.synchronize()
        assert torch.equal(got, FK.mont_batch_inv_plain(x, fp, 2, nr)), n
        one = F.ones((n,), dev)
        assert torch.equal(F.mul(x, got),
                           torch.where(F.is_zero(x), torch.zeros_like(one),
                                       one))


def test_batch_inv_kernels_strided_and_batched(dev):
    """A strided view and leading batch axes go in as the same lanes."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops

    fp = params.get_field("bls12_381_fp")
    x = _inv_inputs(get_field_ops(fp), 1, dev)[-1][:, :6000]
    view = x[:, 1::2]
    assert not view.is_contiguous()
    want = FK.mont_batch_inv_plain(view.contiguous(), fp)
    assert torch.equal(FK.mont_batch_inv(view, fp), want)
    batched = x[:, :6000].reshape(12, 3, 40, 50)
    assert torch.equal(FK.mont_batch_inv(batched, fp),
                       FK.mont_batch_inv_plain(x, fp).reshape(12, 3, 40, 50))


def test_batch_inv_routes(dev, monkeypatch):
    """On a CUDA tensor every batch inversion of the fields (batch_inv and
    batch_inv_tree, degree 1 and 2, and the tree level's batch_inv_flat)
    launches up, pow and down once and never calls a plain version; on a
    CPU tensor none launches."""
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ff.ext import get_fp2_ops
    from sppark_tpu_torch.msm.tree import batch_inv_flat

    plain = []
    for name in ("mont_batch_inv_plain", "inv_up_plain", "inv_down_plain",
                 "mont_pow_plain", "mont_mul_plain"):
        monkeypatch.setattr(FK, name, lambda *a, _n=name, **k:
                            plain.append(_n))
    F = get_field_ops("bls12_381_fp")
    F2 = get_fp2_ops(params.get_curve("bls12_381_g2").fp2)
    x1 = _canon_words(F, 64, 4, dev)
    x2 = torch.cat([x1, x1.flip(1)])
    for f, x in ((F.batch_inv, x1), (F.batch_inv_tree, x1[:, 1:33]),
                 (F2.batch_inv, x2), (F2.batch_inv_tree, x2[:, 1:33]),
                 (lambda d: batch_inv_flat(F, d), x1[:, 1:]),
                 (lambda d: batch_inv_flat(F2, d), x2[:, 1:])):
        before = dict(FK.launches)
        f(x)
        torch.cuda.synchronize()
        assert {k: FK.launches[k] - before[k] for k in before} == {
            "bigmont_ew": 0, "bigmont_pow": 1, "bigmont_inv_up": 1,
            "bigmont_inv_down": 1}
    assert plain == []
    monkeypatch.undo()
    before = dict(FK.launches)
    F.batch_inv(x1[:, :8].cpu())
    F2.batch_inv_tree(x2[:, :4].cpu())
    assert FK.launches == before


@pytest.mark.parametrize("curve", MSM_CURVES)
def test_point_kernels_vs_plain(dev, curve):
    from sppark_tpu_torch.ec import kernels as EK

    p, a, q = _point_cases(curve, 96, dev)
    for got, want in ((EK.xyzz_madd(curve, p, a),
                       EK.xyzz_madd_plain(curve, p, a)),
                      (EK.xyzz_add(curve, p, q),
                       EK.xyzz_add_plain(curve, p, q)),
                      (EK.xyzz_dbl(curve, p), EK.xyzz_dbl_plain(curve, p))):
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, want))


#: the G1 madd and add's element, mont::FpCC, at n32 = 2 (p = 2^64 - 59,
#: no spare bit), 8 (255 and 254 bits) and 12 (381 and 377 bits)
CC_CURVES = ["test_bm64", "pallas", "bn254", "bls12_381", "bls12_377"]


def _carry_lanes(curve, n, dev):
    """_point_cases with lanes 40..43 set to coordinates p - 1 and p - 2
    (every word near its top: the carry chains' edge): 40 all p - 1, 41 all
    p - 2, 42 and 43 the bucket at one and the points at the other."""
    from sppark_tpu_torch.ff.kernels import int_words

    p, a, q = _point_cases(curve, n, dev)
    fp = params.get_curve(curve).field
    deg = params.get_curve(curve).degree

    def col(v):
        return torch.tensor(int_words(v, fp.n_ref_limbs) * deg,
                            dtype=torch.int64).to(torch.int32).to(dev)

    m1, m2 = col(fp.modulus - 1), col(fp.modulus - 2)
    p, a, q = ([c.clone() for c in t] for t in (p, a, q))
    for lane, bucket, other in ((40, m1, m1), (41, m2, m2), (42, m1, m2),
                                (43, m2, m1)):
        for c in p:
            c[:, lane] = bucket
        for c in a + q:
            c[:, lane] = other
    return tuple(p), tuple(a), tuple(q)


def _table_index(n, rows, seed, dev):
    """n slot indices into a gather table of `rows` = 2 m + 1 rows: every
    kind of row (a point, a negated point, the zero row 2 m), some rows
    repeated."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, rows, size=n)
    idx[:6] = [0, rows // 2, rows - 1, rows - 1, 5, 5]
    return torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("curve", CC_CURVES)
def test_carry_chain_madd_add_vs_plain(dev, curve):
    """The G1 madd, add and dbl on the carry-chain element against their
    plain versions word for word: an empty bucket, the affine point at
    infinity (the table's zero row), equal points (the doubling leg),
    opposite points, coordinates p - 1 and p - 2, and a warp with no
    special lane; then the madd through a table and its slot index
    (negated rows, the zero row, repeated rows) against the plain gather
    and madd; the dbl at 16 lanes (the integrate's shape: ZZ == 0, Y == 0
    and the p - 1 / p - 2 lanes among them) and at 4097 lanes (the 96
    lanes tiled: a block past the end)."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import slab

    p, a, q = _carry_lanes(curve, 96, dev)
    before = dict(EK.launches)
    for lanes in (slice(None), slice(0, 32)):
        pw, aw, qw = (tuple(c[:, lanes] for c in t) for t in (p, a, q))
        for got, want in ((EK.xyzz_madd(curve, pw, aw),
                           EK.xyzz_madd_plain(curve, pw, aw)),
                          (EK.xyzz_add(curve, pw, qw),
                           EK.xyzz_add_plain(curve, pw, qw))):
            torch.cuda.synchronize()
            assert all(torch.equal(u, v) for u, v in zip(got, want)), lanes
    rows = slab.point_rows(get_curve_ops(curve, FK.PLAIN).F, *a)
    w = a[0].shape[0]
    table = (rows[:, :w].T, rows[:, w:].T)
    idx = _table_index(96, rows.shape[0], 3, dev)
    got = EK.xyzz_madd(curve, p, table, idx)
    torch.cuda.synchronize()
    want = EK.xyzz_madd_plain(curve, p, table, idx)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert all(torch.equal(u, v) for u, v in zip(
        want, EK.xyzz_madd_plain(curve, p, tuple(
            c.index_select(1, idx) for c in table))))
    for lanes in (torch.arange(32, 48), torch.arange(4097) % 96):
        pw = tuple(c.index_select(1, lanes.to(dev)) for c in p)
        got = EK.xyzz_dbl(curve, pw)
        torch.cuda.synchronize()
        want = EK.xyzz_dbl_plain(curve, pw)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), len(lanes)
    assert {k: v - before[k] for k, v in EK.launches.items()} == {
        "ec_xyzz_madd": 3, "ec_xyzz_add": 2, "ec_xyzz_dbl": 2,
        "ec_pair_prep": 0, "ec_pair_finish": 0}


def test_g1_carry_chain_launch_refuses_p_without_spare_bit(dev):
    """The G1 point kernels on the carry-chain element (madd, add, dbl,
    pair finish) need p < 2^255 at n32 = 8: constants of p = 2^256 - 189
    (prime, top bit set) are refused at the C entry point with
    cudaErrorInvalidValue, where Pallas's launch; the pair prep, on
    mont::Fp, takes both."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.kernels import int_words

    p = (1 << 256) - 189
    bad = np.asarray(int_words(p, 8) + int_words((1 << 256) % p, 8)
                     + [0] * 8 + [-pow(p, -1, 1 << 32) % (1 << 32), 0],
                     dtype=np.uint32)
    good = FK.field_consts(params.get_field("pallas"))
    x = torch.zeros((8, 4), dtype=torch.int32, device=dev)
    out = torch.empty((32, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_in, refused in (("ec_xyzz_madd", 6, True),
                                ("ec_xyzz_add", 8, True),
                                ("ec_xyzz_dbl", 4, True),
                                ("ec_pair_finish", 6, True),
                                ("ec_pair_prep", 4, False)):
        views = np.zeros(5 * n_in, dtype=np.int64)
        for k in range(n_in):
            views[5 * k:5 * k + 3] = (x.data_ptr(), x.stride(0), 1)
        fn = getattr(EK._lib(name), name)
        for consts, rc in ((bad, int(refused)), (good, 0)):
            assert fn(8, views.ctypes.data, out.data_ptr(), 4,
                      consts.ctypes.data, stream) == rc, name
    torch.cuda.synchronize()


@pytest.mark.parametrize("curve", ["test_bm64_g2", "bn254_g2",
                                   "bls12_381_g2", "bls12_377_g2"])
def test_fp2_indexed_madd_vs_plain(dev, curve):
    """The lane-pair G2 madd through a table and its slot index (negated
    rows, the zero row, repeated rows) against the plain gather and
    madd."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import slab

    p, a, _ = _point_cases(curve, 96, dev)
    rows = slab.point_rows(get_curve_ops(curve, FK.PLAIN).F, *a)
    w = a[0].shape[0]
    table = (rows[:, :w].T, rows[:, w:].T)
    for n in (96, 17):
        idx = _table_index(n, rows.shape[0], n, dev)
        pn = tuple(c[:, :n] for c in p)
        got = EK.xyzz_madd(curve, pn, table, idx)
        torch.cuda.synchronize()
        want = EK.xyzz_madd_plain(curve, pn, table, idx)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), n


def test_msm_on_card(dev):
    """test_bm64 MSM 2^10 through the entry point against msm_naive, every
    kernel of the slab MSM launched."""
    import random
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import mult_pippenger
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive

    cp = params.get_curve("test_bm64")
    o = get_oracle(cp)
    rng = random.Random(5)
    pts = [o.random_point(rng) for _ in range(1 << 10)]
    pts[5] = pts[4]
    sc = [rng.randrange(cp.scalar.modulus) for _ in range(1 << 10)]
    sc[0], sc[1], sc[4], sc[5] = 0, cp.scalar.modulus - 1, 2, 2
    EK.reset_launches()
    FK.reset_launches()
    assert mult_pippenger("test_bm64", pts, sc) == msm_naive(cp, pts, sc)
    assert all(EK.launches[EK.kernel_name(op, "test_bm64")] > 0
               for op in EK.SLAB_OPS)
    assert FK.launches["bigmont_ew"] > 0


# -- the G2 (fp2) point kernels ----------------------------------------------------

G2_CURVES = ["test_bm64_g2", "bn254_g2", "bls12_381_g2", "bls12_377_g2"]


@pytest.mark.parametrize("curve", G2_CURVES)
def test_fp2_point_kernels_vs_plain(dev, curve):
    """Each fp2 kernel against its plain version with the planted lanes,
    on the four G2 curves (nonresidues 7, -1, -1, -5), and the madd on
    point-major rows as the MSM's slab gives them."""
    from sppark_tpu_torch.ec import kernels as EK

    p, a, q = _point_cases(curve, 96, dev)
    rows = torch.cat([a[0], a[1]]).T.contiguous()
    w = a[0].shape[0]
    a_rows = (rows[:, :w].T, rows[:, w:].T)
    before = dict(EK.fp2_launches)
    for got, want in ((EK.xyzz_madd(curve, p, a),
                       EK.xyzz_madd_plain(curve, p, a)),
                      (EK.xyzz_madd(curve, p, a_rows),
                       EK.xyzz_madd_plain(curve, p, a)),
                      (EK.xyzz_add(curve, p, q),
                       EK.xyzz_add_plain(curve, p, q)),
                      (EK.xyzz_dbl(curve, p), EK.xyzz_dbl_plain(curve, p))):
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert {k: v - before[k] for k, v in EK.fp2_launches.items()} == {
        "ec_fp2_xyzz_madd": 2, "ec_fp2_xyzz_add": 1, "ec_fp2_xyzz_dbl": 1,
        "ec_fp2_pair_prep": 0, "ec_fp2_pair_finish": 0}


@pytest.mark.parametrize("curve", G2_CURVES)
def test_fp2_madd_lane_pair_warps(dev, curve):
    """The madd runs each bucket on a lane pair, 16 buckets a warp: warps
    with exactly one doubling pair and one pair at infinity (the affine
    point, or the bucket), and 1, 17 and 65 lanes, equal their plain
    versions word for word."""
    from sppark_tpu_torch.ec import kernels as EK

    p, a, _ = _point_cases(curve, 96, dev)
    cases = []
    for inf in (35, 36):
        lanes = list(range(16))
        lanes[5], lanes[9] = 33, inf
        cases.append(lanes)
    cases += [list(range(n)) for n in (1, 17, 65)]
    for lanes in cases:
        pw, aw = (tuple(c[:, lanes] for c in t) for t in (p, a))
        got = EK.xyzz_madd(curve, pw, aw)
        torch.cuda.synchronize()
        want = EK.xyzz_madd_plain(curve, pw, aw)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), lanes


def _lane_pair_warps(specials):
    """Lane selections for a kernel that runs a lane on a pair of threads,
    16 lanes a warp: for each special lane, a warp of the generic lanes
    0..15 with that one lane in slot 5; then 1, 17 and 65 lanes, whose
    threads end inside a block."""
    out = []
    for s in specials:
        lanes = list(range(16))
        lanes[5] = s
        out.append(lanes)
    return out + [list(range(n)) for n in (1, 17, 65)]


@pytest.mark.parametrize("curve", G2_CURVES)
def test_fp2_add_lane_pair_warps(dev, curve):
    """The add runs each lane on a lane pair, 16 lanes a warp: warps with
    exactly one doubling lane (p == q), one lane with q at infinity, one
    with p at infinity, one cancelling lane (p == -q), and 1, 17 and 65
    lanes, equal their plain versions word for word."""
    from sppark_tpu_torch.ec import kernels as EK

    p, _, q = _point_cases(curve, 96, dev)
    for lanes in _lane_pair_warps((33, 35, 36, 34)):
        pw, qw = (tuple(c[:, lanes] for c in t) for t in (p, q))
        got = EK.xyzz_add(curve, pw, qw)
        torch.cuda.synchronize()
        want = EK.xyzz_add_plain(curve, pw, qw)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), lanes


@pytest.mark.parametrize("curve,n", [("test_bm64_g2", 1 << 10),
                                     ("bls12_381_g2", 64)])
def test_g2_msm_on_card(dev, curve, n):
    """A G2 MSM through the entry point against msm_naive, with infinity,
    zero, r - 1 and a doubling term planted; every fp2 kernel of the slab
    MSM and the Montgomery multiply launched."""
    import random
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import mult_pippenger
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive

    cp = params.get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(6)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = o.infinity_affine()
    r = cp.scalar.modulus
    sc = [rng.randrange(r) for _ in range(n)]
    sc[0], sc[1], sc[4], sc[12] = 0, r - 1, 5, 5
    EK.reset_launches()
    FK.reset_launches()
    assert mult_pippenger(curve, pts, sc) == msm_naive(cp, pts, sc)
    assert all(EK.fp2_launches[EK.kernel_name(op, curve)] > 0
               for op in EK.SLAB_OPS)
    assert FK.launches["bigmont_ew"] > 0


# -- the batch-affine pair kernels and the tree MSM ------------------------------

def _pair_cases(curve, n, dev):
    """Affine l, r over n >= 96 lanes.  Lanes 0..31 (a warp) hold generic
    pairs, no doubling; in the second warp lane 33 doubles, 34 cancels, 35
    has l at infinity, 36 r, 37 both, 38 doubles a y == 0 point (not on
    the curve: the toinf case); lanes 64..95 all double."""
    import random
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.oracle.ec import get_oracle

    o = get_oracle(params.get_curve(curve))
    rng = random.Random(12)
    pool = [o.random_point(rng) for _ in range(8)]
    j = [rng.randrange(8) for _ in range(n)]
    L = [pool[k] for k in j]
    R = [pool[(k + 1 + rng.randrange(7)) % 8] for k in j]
    R[33] = L[33]
    R[34] = o.affine_neg(L[34])
    L[35] = L[37] = R[36] = R[37] = o.infinity_affine()
    R[64:96] = L[64:96]
    ops = get_curve_ops(curve, FK.PLAIN)
    l, r = ops.affine_from_ints(L, dev), ops.affine_from_ints(R, dev)
    l[1][:, 38] = r[1][:, 38] = 0
    r[0][:, 38] = l[0][:, 38]
    return l, r


def _pair_table(l, r):
    """A point table holding l's lanes, then r's, then the zero row, and
    the index pair that reads l and r back from it, as a tree's first
    level reads the level-0 index."""
    W, n = l[0].shape
    rows = torch.cat([torch.cat(l).T, torch.cat(r).T,
                      torch.zeros((1, 2 * W), dtype=torch.int32,
                                  device=l[0].device)]).contiguous()
    i = torch.arange(n, dtype=torch.int32, device=l[0].device)
    return (rows[:, :W].T, rows[:, W:].T), (i, i + n)


def _limb_major(l, r):
    """l and r as the even and odd lanes of one limb-major level."""
    W, n = l[0].shape
    X = torch.stack([l[0], r[0]], -1).reshape(W, 2 * n)
    Y = torch.stack([l[1], r[1]], -1).reshape(W, 2 * n)
    return (X[:, 0::2], Y[:, 0::2]), (X[:, 1::2], Y[:, 1::2])


@pytest.mark.parametrize("curve", MSM_CURVES + G2_CURVES)
def test_pair_kernels_vs_plain(dev, curve):
    """ec_[fp2_]pair_prep and _finish against their plain versions with the
    planted lanes and warps, on limb-major operands and on the operands
    that a tree level reads: the point table through the level-0 index
    (level 1) and every other lane of a limb-major level."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm.tree import batch_inv_flat

    l, r = _pair_cases(curve, 128, dev)
    W, n = l[0].shape
    den, flags = EK.affine_pair_prep_plain(curve, l, r)
    inv = batch_inv_flat(get_curve_ops(curve, FK.PLAIN).F, den)
    want = EK.affine_pair_finish_plain(curve, l, r, inv, flags)
    table, (il, ir) = _pair_table(l, r)
    name = EK.kernel_name("pair_prep", curve)
    counts = EK.launches if name in EK.launches else EK.fp2_launches
    before = counts[name]
    for k in (slice(0, 32), slice(32, 64), slice(64, 96), slice(0, n)):
        for lk, rk, ix in ((tuple(c[:, k] for c in l),
                            tuple(c[:, k] for c in r), None),
                           (table, table, (il[k], ir[k])),
                           _limb_major(*(tuple(c[:, k] for c in t)
                                         for t in (l, r))) + (None,)):
            got = EK.affine_pair_prep(curve, lk, rk, ix)
            torch.cuda.synchronize()
            assert torch.equal(got[0], den[:, k])
            assert torch.equal(got[1], flags[k])
            got = EK.affine_pair_finish(curve, lk, rk, inv[:, k], flags[k],
                                        ix)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w[:, k]) for g, w in zip(got, want))
    assert counts[name] == before + 12
    assert sorted(set(flags.tolist())) == [0, 1, 3, 4, 8]


#: one curve of each width and degree: n32 = 2, 8, 12
PAIR_WIDTHS = ["test_bm64", "pallas", "bls12_381", "test_bm64_g2", "bn254_g2",
               "bls12_381_g2"]


@pytest.mark.parametrize("curve", PAIR_WIDTHS)
def test_indexed_pair_kernels_vs_plain(dev, curve):
    """The pair kernels through a table and an index (random rows of a
    point table with negated rows and the zero row, so every case of the
    flag word) against their plain versions, exactly, at 1, 63, 64, 65
    and 4097 lanes: the lane-pair kernels' tile ends inside a block, at
    its end and one lane past it."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import slab
    from sppark_tpu_torch.msm.tree import batch_inv_flat

    ops = get_curve_ops(curve, FK.PLAIN)
    l, _ = _pair_cases(curve, 96, dev)
    rows = slab.point_rows(ops.F, *l)
    W, m = l[0].shape[0], rows.shape[0]
    table = (rows[:, :W].T, rows[:, W:].T)
    g = np.random.default_rng(16)
    idx = g.integers(0, m, size=(2, 4097))
    # doubling, cancellation, infinity on each side and on both
    idx[:, :5] = [[5, 7, m - 1, 9, m - 1], [5, 7 + m // 2, 3, m - 1, m - 1]]
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    for n in (1, 63, 64, 65, 4097):
        ix = (idx[0, :n], idx[1, :n])
        den, flags = EK.affine_pair_prep(curve, table, table, ix)
        torch.cuda.synchronize()
        want = EK.affine_pair_prep_plain(curve, table, table, ix)
        assert torch.equal(den, want[0]) and torch.equal(flags, want[1]), n
        inv = batch_inv_flat(ops.F, den)
        got = EK.affine_pair_finish(curve, table, table, inv, flags, ix)
        torch.cuda.synchronize()
        want = EK.affine_pair_finish_plain(curve, table, table, inv, flags,
                                           ix)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), n
    assert sorted(set(flags.tolist())) == [0, 1, 3, 4, 8]


@pytest.mark.parametrize("curve", G2_CURVES)
def test_fp2_pair_finish_lane_pair_warps(dev, curve):
    """The fp2 prep and finish run each pair on a lane pair, 16 lanes a
    warp: warps of chords with exactly one doubling pair, one cancelling
    pair, one pair with l, r or both at infinity (the finish's copy and
    zero lanes), and
    1, 17 and 65 lanes, on limb-major operands, through the table and the
    index, and on the even and odd lanes of a limb-major level, equal
    their plain versions word for word."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm.tree import batch_inv_flat

    l, r = _pair_cases(curve, 128, dev)
    den, flags = EK.affine_pair_prep_plain(curve, l, r)
    inv = batch_inv_flat(get_curve_ops(curve, FK.PLAIN).F, den)
    specials = (33, 34, 35, 36, 37)
    assert [int(flags[k]) for k in specials] == [
        EK.ACTIVE | EK.DBL, 0, EK.USE_R, EK.USE_L, 0]
    assert bool((flags[:32] == EK.ACTIVE).all())
    for lanes in _lane_pair_warps(specials):
        lw, rw = (tuple(c[:, lanes] for c in t) for t in (l, r))
        args = (inv[:, lanes], flags[lanes])
        dw = EK.affine_pair_prep_plain(curve, lw, rw)
        want = EK.affine_pair_finish_plain(curve, lw, rw, *args)
        table, ix = _pair_table(lw, rw)
        for lv, rv, i in ((lw, rw, None), (table, table, ix),
                          _limb_major(lw, rw) + (None,)):
            got = EK.affine_pair_prep(curve, lv, rv, i)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, dw)), lanes
            got = EK.affine_pair_finish(curve, lv, rv, *args, i)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), lanes


@pytest.mark.parametrize("curve,n", [("bls12_381", 1 << 12),
                                     ("bls12_381_g2", 1 << 12)])
def test_tree_msm_on_card(dev, curve, n):
    """mode="tree" through the entry point equals the slab MSM and
    msm_naive on the same input (all-equal scalars too; msm_naive over the
    8 distinct points with each one's scalars summed mod r, the same
    point); the pair kernels, the integrate's add and dbl and the
    Montgomery multiply launched, and the batch inversion's three kernels
    once per level (one prep launch each) and once for to_affine."""
    import random
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive

    cp = params.get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(7)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = o.infinity_affine()
    r = cp.scalar.modulus
    sc = [rng.randrange(r) for _ in range(n)]
    sc[0], sc[1], sc[4], sc[12] = 0, r - 1, 5, 5

    def naive(scalars):
        sums = [sum(k for i, k in enumerate(scalars)
                    if i % 8 == j and i != 3) % r for j in range(8)]
        return msm_naive(cp, base, sums)

    tree = MSMContext(curve, n, mode="tree")
    tree.set_points(pts)
    EK.reset_launches()
    FK.reset_launches()
    got = tree.invoke(sc)
    counts = {k: v for k, v in {**EK.launches, **EK.fp2_launches}.items()
              if v}
    pows = FK.launches["bigmont_pow"]
    invs = (FK.launches["bigmont_inv_up"], FK.launches["bigmont_inv_down"])
    assert got == MSMContext(curve, n).invoke(sc, points=pts)
    assert got == naive(sc)
    assert sorted(counts) == sorted(EK.kernel_name(op, curve)
                                    for op in EK.TREE_OPS)
    assert FK.launches["bigmont_ew"] > 0
    assert pows == counts[EK.kernel_name("pair_prep", curve)] + 1
    assert invs == (pows, pows)
    k = rng.randrange(r)
    assert tree.invoke([k] * n) == naive([k] * n)


# -- the G2 doubling on the carry-chain lane pair; the round MSM modes -------

def _fp2_words(curve, n, seed, dev):
    """(2 n32, n) random canonical fp2 words, edge words in the first
    lanes."""
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    F = get_field_ops(params.get_curve(curve).field)
    return torch.cat([_canon_words(F, n, seed, dev),
                      _canon_words(F, n, seed + 1, dev)])


@pytest.mark.parametrize("curve", G2_CURVES)
def test_fp2_dbl_lane_pair_vs_plain(dev, curve):
    """ec_fp2_xyzz_dbl runs each lane on a lane pair of carry-chain
    threads, 16 lanes a warp: warps with exactly one Y == 0 lane, one
    ZZ == 0 lane, or none, then 1, 17, 65 and 2^18 lanes (random
    coordinates with edge words), equal the plain version word for word;
    one launch each."""
    from sppark_tpu_torch.ec import kernels as EK

    p, _, _ = _point_cases(curve, 96, dev)
    cases = _lane_pair_warps((38, 36)) + [list(range(16))]
    before = EK.fp2_launches["ec_fp2_xyzz_dbl"]
    for lanes in cases:
        pw = tuple(c[:, lanes] for c in p)
        got = EK.xyzz_dbl(curve, pw)
        torch.cuda.synchronize()
        want = EK.xyzz_dbl_plain(curve, pw)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), lanes
    wide = tuple(_fp2_words(curve, 1 << 18, 40 + k, dev) for k in range(4))
    got = EK.xyzz_dbl(curve, wide)
    torch.cuda.synchronize()
    want = EK.xyzz_dbl_plain(curve, wide)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
    assert EK.fp2_launches["ec_fp2_xyzz_dbl"] - before == len(cases) + 1


def test_fp2_dbl_refuses_p_without_spare_bit(dev):
    """The fp2 doubling on the carry-chain element needs p < 2^255 at
    n32 = 8: constants of p = 2^256 - 189 (prime, top bit set; nr = -1)
    are refused at its C entry point with cudaErrorInvalidValue; the
    other fp2 kernels, on mont::Fp, take them."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.kernels import int_words

    p = (1 << 256) - 189
    bad = np.asarray(int_words(p, 8) + int_words((1 << 256) % p, 8)
                     + [0] * 8 + [-pow(p, -1, 1 << 32) % (1 << 32),
                                  (-1) & 0xFFFFFFFF], dtype=np.uint32)
    good = FK.field_consts(params.get_field("bn254_fp"), 0, -1)
    x = torch.zeros((16, 4), dtype=torch.int32, device=dev)
    flags = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    out = torch.empty((64, 4), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name, n_in, refused in (("ec_fp2_xyzz_dbl", 4, True),
                                ("ec_fp2_xyzz_madd", 6, False),
                                ("ec_fp2_xyzz_add", 8, False),
                                ("ec_fp2_pair_prep", 4, False),
                                ("ec_fp2_pair_finish", 6, False)):
        views = np.zeros(5 * n_in, dtype=np.int64)
        for k in range(n_in):
            v = flags if name == "ec_fp2_pair_finish" and k == 5 else x
            views[5 * k:5 * k + 3] = (v.data_ptr(), v.stride(0), 1)
        fn = getattr(EK._lib(name), name)
        for consts, rc in ((bad, int(refused)), (good, 0)):
            assert fn(8, views.ctypes.data, out.data_ptr(), 4,
                      consts.ctypes.data, stream) == rc, name
    torch.cuda.synchronize()


def _tiled_case(curve, n, seed):
    """8 distinct points tiled to n, infinity at index 3, scalars with 0,
    r - 1 and a doubling pair planted; naive(scalars) is msm_naive over
    the 8 points with each one's scalars summed mod r."""
    import random
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.oracle.msm import msm_naive

    cp = params.get_curve(curve)
    o = get_oracle(cp)
    rng = random.Random(seed)
    base = [o.random_point(rng) for _ in range(8)]
    pts = [base[i % 8] for i in range(n)]
    pts[3] = o.infinity_affine()
    r = cp.scalar.modulus
    sc = [rng.randrange(r) for _ in range(n)]
    sc[0], sc[1], sc[4], sc[12] = 0, r - 1, 5, 5

    def naive(coef):
        """coef: a signed multiple of each point."""
        sums = [sum(k for i, k in enumerate(coef) if i % 8 == j and i != 3)
                % r for j in range(8)]
        return msm_naive(cp, base, sums)
    return pts, sc, naive, rng


@pytest.mark.parametrize("mode", ["xyzz", "affine"])
@pytest.mark.parametrize("curve", ["bls12_381", "bls12_381_g2"])
def test_msm_modes_on_card(dev, curve, mode):
    """MSMContext(mode="xyzz" / "affine") at 2^10 through the entry point
    against msm_naive, with Montgomery-form scalars and all-equal scalars
    (rounds = n); the mode's point kernels and the batch inversion
    launched."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.msm import MSMContext

    n = 1 << 10
    pts, sc, naive, rng = _tiled_case(curve, n, 11)
    cp = params.get_curve(curve)
    ctx = MSMContext(curve, n, mode=mode)
    ctx.set_points(pts)
    EK.reset_launches()
    FK.reset_launches()
    assert ctx.invoke(sc) == naive(sc)
    counts = {k: v for k, v in {**EK.launches, **EK.fp2_launches}.items()
              if v}
    ops = (("pair_prep", "pair_finish") if mode == "affine"
           else ("xyzz_madd",)) + ("xyzz_add", "xyzz_dbl")
    assert sorted(counts) == sorted(EK.kernel_name(op, curve) for op in ops)
    assert all(FK.launches[k] > 0 for k in ("bigmont_ew", "bigmont_pow",
                                              "bigmont_inv_up",
                                              "bigmont_inv_down"))
    mont = np.array([[(cp.scalar.to_mont(s) >> (32 * k)) & 0xFFFFFFFF
                      for s in sc] for k in range(ctx.n_words)],
                    dtype=np.uint32)
    assert ctx.invoke(mont, mont=True) == naive(sc)
    k = rng.randrange(cp.scalar.modulus)
    assert ctx.invoke([k] * n) == naive([k] * n)


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_381_g2"])
def test_batch_addition_on_card(dev, curve):
    """batch_addition at 2^10 on the card: a seeded bitmap and refmap,
    every point, the empty selection; madd and add launched."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.msm import batch_addition

    n = 1 << 10
    pts, _, naive, rng = _tiled_case(curve, n, 12)
    bits = [rng.randrange(2) for _ in range(n)]
    refs = [rng.randrange(2) for _ in range(n)]
    EK.reset_launches()
    got = batch_addition(curve, pts, bits, refs)
    assert got == naive([b * (-1 if r else 1) for b, r in zip(bits, refs)])
    counts = {**EK.launches, **EK.fp2_launches}
    assert counts[EK.kernel_name("xyzz_madd", curve)] > 0
    assert counts[EK.kernel_name("xyzz_add", curve)] > 0
    assert batch_addition(curve, pts) == naive([1] * n)
    assert batch_addition(curve, pts, [0] * n).inf


@pytest.mark.parametrize("field", ["bls12_381_fr", "goldilocks"])
def test_polynomial_on_card(dev, field):
    """prefix_sum, prefix_product, div_by_x_minus_z (both layouts) and
    evaluate at n = 4097 (8 points, two passes) on the card against the
    plain path on the card and against the CPU; a wide field's products
    launched bigmont_ew."""
    from sppark_tpu_torch import polynomial as P
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.ff.bigmont import get_field_ops
    from sppark_tpu_torch.ntt.core import elem_ops

    lead = elem_ops(field).lead
    F = get_field_ops(field) if lead else None
    p = params.get_field(field).modulus
    g = np.random.default_rng(41)
    n = 4097
    vals = [int(v) for v in g.integers(0, min(p, 1 << 63), size=n + 9)]
    if lead:
        mk = lambda v, shape: F.from_int_list(v, shape)     # noqa: E731
    else:
        mk = lambda v, shape: gl64.from_ints(v).reshape(shape)  # noqa: E731
    c, z, xs = mk(vals[:n], (n,)), mk(vals[n:n + 1], (1,)), mk(vals[-8:],
                                                                (8,))
    FK.reset_launches()
    outs = [P.prefix_sum(field, c.to(dev)), P.prefix_product(field, c.to(dev)),
            *P.div_by_x_minus_z(field, c.to(dev), z.to(dev)),
            P.div_by_x_minus_z(field, c.to(dev), z.to(dev), rotate=True),
            P.evaluate(field, c.to(dev), xs.to(dev), pass_elems=4 * n)]
    torch.cuda.synchronize()
    assert (FK.launches["bigmont_ew"] > 0) == bool(lead)
    plain = [P.prefix_sum(field, c.to(dev), FK.PLAIN),
             P.prefix_product(field, c.to(dev), FK.PLAIN),
             *P.div_by_x_minus_z(field, c.to(dev), z.to(dev), kern=FK.PLAIN),
             P.div_by_x_minus_z(field, c.to(dev), z.to(dev), True, FK.PLAIN),
             P.evaluate(field, c.to(dev), xs.to(dev), FK.PLAIN, 4 * n)]
    cpu = [P.prefix_sum(field, c), P.prefix_product(field, c),
           *P.div_by_x_minus_z(field, c, z),
           P.div_by_x_minus_z(field, c, z, rotate=True),
           P.evaluate(field, c, xs, pass_elems=4 * n)]
    for k, (a, b, h) in enumerate(zip(outs, plain, cpu)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), h), k


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_381_g2"])
def test_scalar_mul_jacobian_on_card(dev, curve):
    """scalar_mul and the jacobian ops on 64 lanes (8 points tiled, one at
    infinity) against the oracle; their products launched bigmont_ew."""
    from sppark_tpu_torch.ec.core import get_curve_ops
    from sppark_tpu_torch.ff import kernels as FK
    from sppark_tpu_torch.oracle.ec import get_oracle

    pts, _, _, rng = _tiled_case(curve, 64, 13)
    cp = params.get_curve(curve)
    o = get_oracle(cp)
    ops = get_curve_ops(curve)
    a = ops.affine_from_ints(pts, dev)
    k = rng.randrange(cp.scalar.modulus)
    FK.reset_launches()
    got = ops.affine_to_ints(ops.xyzz_to_affine(ops.scalar_mul(a, k)))
    j = ops.affine_to_jacobian(a)
    s = ops.jacobian_add(j, ops.jacobian_dbl(j))
    got3 = ops.affine_to_ints(ops.jacobian_to_affine(s))
    x2 = ops.xyzz_dbl(ops.affine_to_xyzz(a))
    via = ops.affine_to_ints(ops.jacobian_to_affine(ops.xyzz_to_jacobian(x2)))
    assert FK.launches["bigmont_ew"] > 0
    z = (o.zero, o.zero)
    for i, pt in enumerate(pts[:16]):          # lane 3 at infinity
        km = o.jacobian_to_affine(o.scalar_mul(pt, k))
        t3 = o.jacobian_to_affine(o.scalar_mul(pt, 3))
        t2 = o.jacobian_to_affine(o.scalar_mul(pt, 2))
        for got_l, want in ((got, km), (got3, t3), (via, t2)):
            assert got_l[i] == (z if want.inf else (want.x, want.y)), i
    for got_l in (got, got3, via):             # the rest: the 8 tiled
        assert all(got_l[i] == got_l[8 + i % 8] for i in range(16, 64))


@pytest.mark.parametrize("curve", ["bls12_381", "bls12_381_g2"])
def test_madd_sign_on_card(dev, curve):
    """xyzz_madd with `sign` on the card, per-lane points and through a
    table and its index, against the plain version with sign: the sign
    rides the index into the table beside its negation."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.ec.core import get_curve_ops

    pts, _, _, rng = _tiled_case(curve, 64, 14)
    ops = get_curve_ops(curve)
    a = ops.affine_from_ints(pts, dev)
    p = ops.xyzz_dbl(ops.affine_to_xyzz(ops.affine_from_ints(pts[::-1], dev)))
    sign = torch.tensor([rng.randrange(2) == 1 for _ in range(64)],
                        device=dev)
    idx = torch.tensor([rng.randrange(64) for _ in range(64)],
                       dtype=torch.int32, device=dev)
    name = EK.kernel_name("xyzz_madd", curve)
    EK.reset_launches()
    got = EK.xyzz_madd(curve, p, a, sign=sign)
    got_t = EK.xyzz_madd(curve, p, a, idx, sign=sign)
    torch.cuda.synchronize()
    assert {**EK.launches, **EK.fp2_launches}[name] == 2
    for u, v in ((got, EK.xyzz_madd_plain(curve, p, a, sign=sign)),
                 (got_t, EK.xyzz_madd_plain(curve, p, a, idx, sign))):
        assert all(torch.equal(x, y) for x, y in zip(u, v))


def test_sharded_on_group_of_one(dev):
    """The sharded NTT (Goldilocks 2^12, BN254 Fr 2^10; flat and matrix,
    forward and inverse) and MSM (BLS12-381 G1 2^10) on an NCCL group of
    one, against the single-device NTT, MSMContext(mode="xyzz") and
    msm_naive."""
    from sppark_tpu_torch.msm import MSMContext
    from sppark_tpu_torch.ntt.core import elem_ops
    from sppark_tpu_torch.parallel import (destroy, init_distributed,
                                           make_mesh, msm_sharded,
                                           ntt_matrix_sharded, ntt_sharded)

    assert init_distributed() == 1
    try:
        mesh = make_mesh()
        assert mesh.size == 1 and mesh.device.type == "cuda"
        for field, lg in (("goldilocks", 12), ("bn254_fr", 10)):
            E = elem_ops(field)
            n = 1 << lg
            if E.lead:
                from sppark_tpu_torch.ff.bigmont import get_field_ops
                x = get_field_ops(field).from_int_list(
                    range(3, 3 + n), device=dev)
            else:
                x = gl64.from_ints(range(3, 3 + n), dev)
            for inverse in (False, True):
                want = ntt.base_dev(field, x, lg, direction=ntt.Direction(
                    int(inverse)))
                got = ntt_sharded(field, x, lg, mesh, inverse=inverse)
                assert torch.equal(got, want), (field, inverse)
                n1, n2 = 1 << (lg // 2), 1 << (lg - lg // 2)
                d = ntt_matrix_sharded(field, x.reshape(x.shape[:-1]
                                                        + (n1, n2)),
                                       lg, mesh, inverse=inverse)
                assert torch.equal(d, want.reshape(
                    want.shape[:-1] + (n2, n1)).transpose(-1, -2)), field
        curve, n = "bls12_381", 1 << 10
        pts, sc, naive, _ = _tiled_case(curve, n, 15)
        ctx = MSMContext(curve, n, mode="xyzz")
        ctx.set_points(pts)
        assert msm_sharded(curve, pts, sc, mesh) == ctx.invoke(sc) \
            == naive(sc)
    finally:
        destroy()


def test_examples_on_card(dev):
    """Both examples' main on the card (no --cpu) at small sizes: the NTT
    example on goldilocks and baby_bear at 2^12 through the narrow
    kernels, equal to its run with --cpu; the MSM example on bn254 at
    2^10 through the point kernels, equal to the native host MSM (the
    example asserts it) and on the curve, and on test_gl64 at 2^8 (plain
    point ops on every device) equal to its run with --cpu."""
    from sppark_tpu_torch.ec import kernels as EK
    from sppark_tpu_torch.examples import msm_example, ntt_example
    from sppark_tpu_torch.oracle.ec import get_oracle
    from sppark_tpu_torch.runtime import accelerator_available

    assert accelerator_available()
    for field in ("goldilocks", "baby_bear"):
        K.reset_launches()
        out = ntt_example.main([field, "12"])
        counts = {**K.launches, **K.narrow_launches}
        assert all(v > 0 for k, v in counts.items()
                   if k.startswith("gl64" if field == "goldilocks"
                                   else "mont32")), counts
        cpu = ntt_example.main([field, "12", "--cpu"])
        for k in ("data", "ntt", "coset_ntt", "lde"):
            assert np.array_equal(out[k], cpu[k]), (field, k)
    EK.reset_launches()
    out = msm_example.main(["bn254", "10"])
    assert EK.launches["ec_xyzz_madd"] > 0
    assert out["host"] is not None and out["result"] == out["host"]
    assert get_oracle(params.get_curve("bn254")).on_curve(out["result"])
    got = msm_example.main(["test_gl64", "8"])["result"]
    assert got == msm_example.main(["test_gl64", "8", "--cpu"])["result"]
