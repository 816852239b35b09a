"""The Montgomery multiply kernel's wrappers, each beside its plain PyTorch
version.

`mont_mul` and `mont_sqr` run csrc/bigmont.cu:bigmont_ew (the port of
sppark_tpu/ff/bigmont.py:_ew_call_cached); `mont_pow` runs the same file's
bigmont_pow, a whole fixed-exponent chain of those products in one launch
(the field's Fermat inversion); `mont_batch_inv` inverts every lane of a
batch (degree 1, or fp2 through the norm) in three launches:
csrc/batch_inv.cu's bigmont_inv_up, bigmont_pow over one product per
block, bigmont_inv_down (Montgomery's trick in chunks).  On a CUDA tensor
a wrapper launches its kernels on the current stream or raises; on a CPU
tensor it computes the same function with the plain version.  Each
launch adds one to `launches[kernel]`.

An element is n32 32-bit words, limb-major `(n32, *batch)`, held as the u32
bit pattern in an int32 tensor; R = 2^(32 n32), so the Montgomery words
equal the JAX package's 16-bit-limb words bit for bit.  CPU torch has no
unsigned 32-bit ops, so the plain versions work on int64: 16-bit limbs for
the product (the schoolbook and word-by-word Montgomery reduction of
`BigMontField._mul_xla`, O(n32) tensor steps), and whole 32-bit words in
[0, 2^32) for the carries and the final subtraction.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import _build
from ..params import FieldParams
from ..util.errors import SpparkError
from . import inversion

M16 = 0xFFFF
M32 = 0xFFFFFFFF

launches = {"bigmont_ew": 0, "bigmont_pow": 0, "bigmont_inv_up": 0,
            "bigmont_inv_down": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# -- word helpers (int64 tensors holding u32 words) ----------------------------

def words64(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2^32)."""
    return x.to(torch.int64) & M32


def words32(w: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 words with the same bit pattern."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def int_words(v: int, n32: int):
    """The n32 little-endian 32-bit words of v, as Python ints."""
    return [(v >> (32 * i)) & M32 for i in range(n32)]


def carry_words(w):
    """Propagate carries through rows of int64 sums >= 0 -> (words in
    [0, 2^32) as a list of rows, carry out of the top row)."""
    out, c = [], 0
    for row in w:
        s = row + c
        out.append(s & M32)
        c = s >> 32
    return out, c


def sub_words(a, b):
    """a - b over rows of u32 words (b's rows may be ints) -> (rows, borrow
    out as 0/1 int64)."""
    out, br = [], 0
    for x, y in zip(a, b):
        d = x - y - br
        br = (d < 0).to(torch.int64)
        out.append(d + (br << 32))
    return out, br


def reduce_once(rows, top, params: FieldParams) -> torch.Tensor:
    """Rows of u32 words (plus the bit `top` above them) holding a value
    < 2p -> the canonical value as (n32, *batch) int32 words."""
    d, br = sub_words(rows, int_words(params.modulus, len(rows)))
    use_d = ((br == 0) | (top != 0))
    return words32(torch.where(use_d, torch.stack(d), torch.stack(rows)))


def mod_add(x, y, params: FieldParams) -> torch.Tensor:
    """x + y mod p over canonical (n32, *batch) words."""
    x, y = torch.broadcast_tensors(words64(x), words64(y))
    rows, carry = carry_words(list(x + y))
    return reduce_once(rows, carry, params)


def mod_sub(x, y, params: FieldParams) -> torch.Tensor:
    """x - y mod p over canonical (n32, *batch) words."""
    x, y = torch.broadcast_tensors(words64(x), words64(y))
    d, br = sub_words(list(x), list(y))
    rows, _ = carry_words([r + w * br for r, w in
                           zip(d, int_words(params.modulus, len(d)))])
    return words32(torch.stack(rows))


def add_small_multiple(t0, t1, k: int, params: FieldParams) -> torch.Tensor:
    """t0 + k t1 mod p for a small signed k != 0, |k| t1 by doubling and
    adding (the fp2 nonresidue's products, mont.cuh:times)."""
    acc, run, m = None, t1, abs(k)
    while m:
        if m & 1:
            acc = run if acc is None else mod_add(acc, run, params)
        m >>= 1
        if m:
            run = mod_add(run, run, params)
    return mod_add(t0, acc, params) if k > 0 else mod_sub(t0, acc, params)


# -- plain versions --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _p16(params: FieldParams, device: torch.device) -> torch.Tensor:
    L = 2 * params.n_ref_limbs
    return torch.tensor([(params.modulus >> (16 * i)) & M16
                         for i in range(L)], dtype=torch.int64,
                        device=device)


def _limbs16(w64: torch.Tensor) -> torch.Tensor:
    """(n32, *b) int64 words -> (2 n32, *b) int64 16-bit limbs."""
    limbs = torch.stack([w64 & M16, w64 >> 16], dim=1)
    return limbs.reshape((2 * w64.shape[0],) + tuple(w64.shape[1:]))


def mont_mul_plain(x: torch.Tensor, y: torch.Tensor,
                   params: FieldParams) -> torch.Tensor:
    """Plain version of bigmont_ew: x * y * R^-1 mod p, canonical."""
    x, y = torch.broadcast_tensors(x, y)
    a, b = _limbs16(words64(x)), _limbs16(words64(y))
    L = a.shape[0]
    batch = tuple(a.shape[1:])
    m0 = params.m0(16)
    p16 = _p16(params, a.device).reshape((L,) + (1,) * len(batch))
    # schoolbook: column k sums a[i] b[k - i]; each product < 2^32 and a
    # column of L of them stays far inside int64
    acc = torch.zeros((2 * L,) + batch, dtype=torch.int64,
                      device=a.device)
    for i in range(L):
        acc[i:i + L] += a[i] * b
    # word-by-word Montgomery reduction: m clears column i mod 2^16, the
    # rest of column i carries into column i + 1
    for i in range(L):
        m = ((acc[i] & M16) * m0) & M16
        acc[i:i + L] += m * p16
        acc[i + 1] += acc[i] >> 16
    # the upper half holds the result (< 2p) in unnormalised 16-bit columns
    top = acc[L:]
    rows, c = carry_words([top[2 * k] + (top[2 * k + 1] << 16)
                           for k in range(L // 2)])
    return reduce_once(rows, c, params)


def mont_sqr_plain(x: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """Plain version of bigmont_ew's square."""
    return mont_mul_plain(x, x, params)


def _one_words(params: FieldParams, x: torch.Tensor) -> torch.Tensor:
    """The Montgomery one in x's shape."""
    col = words32(torch.tensor(int_words(params.one_mont, x.shape[0]),
                               dtype=torch.int64, device=x.device))
    return col.reshape((-1,) + (1,) * (x.ndim - 1)).expand(x.shape).clone()


def mont_pow_plain(x: torch.Tensor, e: int,
                   params: FieldParams) -> torch.Tensor:
    """Plain version of bigmont_pow: x^e, Montgomery form in and out, MSB
    first (pow_byref, ff/pow.hpp); e = 0 gives the Montgomery one."""
    if e == 0:
        return _one_words(params, x)
    acc = x
    for bit in bin(e)[3:]:
        acc = mont_sqr_plain(acc, params)
        if bit == "1":
            acc = mont_mul_plain(acc, x, params)
    return acc


# -- batch inversion: Montgomery's trick in chunks --------------------------

#: csrc/batch_inv.cu's threads a block (T) and lanes a thread (C): thread t
#: of block b owns lanes b T C + j T + t, j < C
INV_THREADS, INV_CHUNK = 256, 16


def _inv_factor(x, params: FieldParams, degree: int, nr: int):
    """The lane factors (n32, n) of flat (degree n32, n) words: the lanes
    themselves, or in degree 2 their norms a0^2 - nr a1^2."""
    if degree == 1:
        return x
    N = params.n_ref_limbs
    return add_small_multiple(mont_sqr_plain(x[:N], params),
                              mont_sqr_plain(x[N:], params), -nr, params)


def _blocked(w, nb: int, T: int, C: int, params: FieldParams):
    """(n32, n) words padded with ones to nb C T lanes -> (n32, nb, C, T):
    lane b C T + j T + t at [:, b, j, t]."""
    pad = _one_words(params, w.new_empty((w.shape[0], nb * C * T
                                          - w.shape[1])))
    return torch.cat([w, pad], 1).reshape(w.shape[0], nb, C, T)


def _safe(d, params: FieldParams):
    """(d with zero lanes replaced by one, the zero lanes)."""
    zero = (d == 0).all(0)
    return torch.where(zero, _one_words(params, d), d), zero


def inv_up_plain(x, params: FieldParams, degree: int = 1, nr: int = 0,
                 threads: int = INV_THREADS, chunk: int = INV_CHUNK):
    """Plain version of bigmont_inv_up on flat (degree n32, n) words, on
    the kernel's schedule.  Returns (pre (n32, n): each lane's inclusive
    prefix product within its thread's chunk; dn (n32, n): the norms in
    degree 2, else None; tp (n32, nb T): the thread products; blk (n32,
    nb): the block products); a zero factor counts as one."""
    T, C = threads, chunk
    N, n = params.n_ref_limbs, x.shape[1]
    nb = -(-n // (T * C))
    d = _inv_factor(x, params, degree, nr)
    f = _blocked(_safe(d, params)[0], nb, T, C, params)
    pre = [f[:, :, 0]]
    for j in range(1, C):
        pre.append(mont_mul_plain(pre[-1], f[:, :, j], params))
    blk = pre[-1]
    while blk.shape[-1] > 1:        # the block's tree, adjacent pairs
        blk = mont_mul_plain(blk[..., 0::2], blk[..., 1::2], params)
    return (torch.stack(pre, 2).reshape(N, -1)[:, :n],
            d if degree == 2 else None, pre[-1].reshape(N, nb * T),
            blk[..., 0])


def inv_down_plain(x, pre, dn, tp, blkinv, params: FieldParams,
                   degree: int = 1, threads: int = INV_THREADS,
                   chunk: int = INV_CHUNK):
    """Plain version of bigmont_inv_down: inv_up_plain's arrays and blkinv
    (n32, nb), the block products' inverses -> the inverses of x's lanes
    (zero for a zero lane), (degree n32, n)."""
    T, C = threads, chunk
    N, n = params.n_ref_limbs, x.shape[1]
    nb = blkinv.shape[1]
    d, zero = _safe(x if degree == 1 else dn, params)
    f = _blocked(d, nb, T, C, params)
    pre = _blocked(pre, nb, T, C, params)
    # down each block's tree of thread products from the root's inverse,
    # which is given: u = 1 / (each thread's chunk product)
    u = inversion.batch_inv_tree(
        lambda a, b: mont_mul_plain(a, b, params),
        lambda root: blkinv[..., None], tp.reshape(N, nb, T))
    inv = [u] * C
    for j in range(C - 1, 0, -1):
        inv[j] = mont_mul_plain(u, pre[:, :, j - 1], params)
        u = mont_mul_plain(u, f[:, :, j], params)
    inv[0] = u
    inv = torch.stack(inv, 2).reshape(N, -1)[:, :n]
    if degree == 1:
        return torch.where(zero, torch.zeros_like(inv), inv)
    return torch.cat([mont_mul_plain(x[:N], inv, params),
                      mod_sub(torch.zeros_like(inv),
                              mont_mul_plain(x[N:], inv, params), params)])


def mont_batch_inv_plain(x, params: FieldParams, degree: int = 1,
                         nr: int = 0, threads: int = INV_THREADS,
                         chunk: int = INV_CHUNK) -> torch.Tensor:
    """Plain version of mont_batch_inv on the kernels' schedule (chunks of
    `chunk` lanes strided by `threads`, one mont_pow_plain over the block
    products), on any device."""
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[1] == 0:
        return x.clone()
    pre, dn, tp, blk = inv_up_plain(flat, params, degree, nr, threads, chunk)
    blkinv = mont_pow_plain(blk, params.modulus - 2, params)
    return inv_down_plain(flat, pre, dn, tp, blkinv, params, degree,
                          threads, chunk).reshape(x.shape)


# -- kernel --------------------------------------------------------------------

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {"bigmont_ew": [_I, _I, _VP, _VP, _VP, _LL, _VP, _VP],
               "bigmont_pow": [_I, _VP, _VP, _LL, _VP, _I, _VP, _VP]}
_INV_SIGNATURES = {
    "bigmont_inv_up": [_I] * 4 + [_VP] * 5 + [_LL, _VP, _VP],
    "bigmont_inv_down": [_I] * 4 + [_VP] * 6 + [_LL, _VP, _VP]}
#: the largest exponent bigmont_pow takes: 12 words (p - 2 of every field)
EXP_WORDS = 12


def _lib() -> ctypes.CDLL:
    return _build.load("bigmont", _SIGNATURES)


def _inv_lib() -> ctypes.CDLL:
    return _build.load("batch_inv", _INV_SIGNATURES)


@functools.lru_cache(maxsize=None)
def field_consts(params: FieldParams, a4: int = 0,
                 nr: int = 0) -> np.ndarray:
    """The kernels' per-launch constants [p, one, a4, m0, nr] as u32 words:
    p, the Montgomery one and a4 (Montgomery form) n32 words each, then
    M0 = -p^-1 mod 2^32, then the fp2 nonresidue u^2 as a small signed
    integer (two's complement; 0 where there is no extension)."""
    if abs(nr) >= 16:
        raise ValueError(f"{params.name}: nonresidue {nr} is not small")
    n32 = params.n_ref_limbs
    words = (int_words(params.modulus, n32) + int_words(params.one_mont, n32)
             + int_words(params.to_mont(a4 % params.modulus), n32)
             + [params.m0(32), nr & M32])
    return np.asarray(words, dtype=np.uint32)


def check_words(name: str, params: FieldParams, *tensors,
                degree: int = 1) -> None:
    """Refuse what a kernel cannot take: other than int32 words, (degree *
    n32, ...) shapes (an fp2 element is c0's n32 words, then c1's), or
    tensors on different devices or off the card."""
    words = degree * params.n_ref_limbs
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: tensors must be int32 words")
        if t.ndim < 1 or t.shape[0] != words:
            raise ValueError(f"{name}: {tuple(t.shape)} is not ({words}, "
                             f"...) words of {params.name}"
                             + (f"^{degree}" if degree > 1 else ""))
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors lie on different devices")
    if tensors[0].device.type != "cuda":
        raise SpparkError(5, f"{name}: no kernel for device "
                             f"{tensors[0].device}")


def _ew(x: torch.Tensor, y: torch.Tensor, params: FieldParams,
        sqr: int) -> torch.Tensor:
    check_words("bigmont_ew", params, x, y)
    x, y = (t.contiguous() for t in torch.broadcast_tensors(x, y))
    out = torch.empty_like(x)
    n = x.numel() // x.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().bigmont_ew(
            x.shape[0], sqr, x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
            field_consts(params).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"bigmont_ew: CUDA error {rc}")
    launches["bigmont_ew"] += 1
    return out


@functools.lru_cache(maxsize=None)
def _exp_words(e: int) -> np.ndarray:
    return np.asarray(int_words(e, EXP_WORDS), dtype=np.uint32)


def _pow(x: torch.Tensor, e: int, params: FieldParams) -> torch.Tensor:
    if not 0 <= e < 1 << (32 * EXP_WORDS):
        raise ValueError(f"bigmont_pow: exponent {e} is not in [0, "
                         f"2^{32 * EXP_WORDS})")
    check_words("bigmont_pow", params, x)
    x = x.contiguous()
    out = torch.empty_like(x)
    n = x.numel() // x.shape[0]
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().bigmont_pow(
            x.shape[0], x.data_ptr(), out.data_ptr(), n,
            _exp_words(e).ctypes.data, e.bit_length(),
            field_consts(params).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"bigmont_pow: CUDA error {rc}")
    launches["bigmont_pow"] += 1
    return out


def _check_degree(degree: int, nr: int) -> None:
    if degree not in (1, 2) or (degree == 2) != (nr != 0):
        raise ValueError(f"batch inversion: degree {degree} with "
                         f"nonresidue {nr}")


def _inv_call(name: str, params: FieldParams, degree: int, nr: int,
              n: int, *ptrs) -> None:
    with torch.cuda.device(ptrs[0].device):
        rc = getattr(_inv_lib(), name)(
            params.n_ref_limbs, degree, INV_THREADS, INV_CHUNK,
            *(None if t is None else t.data_ptr() for t in ptrs), n,
            field_consts(params, nr=nr).ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SpparkError(rc, f"{name}: CUDA error {rc}")
    launches[name] += 1


def inv_up(x: torch.Tensor, params: FieldParams, degree: int = 1,
           nr: int = 0):
    """bigmont_inv_up on flat (degree n32, n) words, n > 0, on the card:
    the arrays of inv_up_plain, in the kernel's scratch."""
    _check_degree(degree, nr)
    check_words("bigmont_inv_up", params, x, degree=degree)
    x = x.contiguous()
    N, n = params.n_ref_limbs, x.shape[1]
    nb = -(-n // (INV_THREADS * INV_CHUNK))

    def new(lanes):
        return torch.empty((N, lanes), dtype=torch.int32, device=x.device)

    pre, tp, blk = new(n), new(nb * INV_THREADS), new(nb)
    dn = new(n) if degree == 2 else None
    _inv_call("bigmont_inv_up", params, degree, nr, n, x, pre, dn, tp, blk)
    return pre, dn, tp, blk


def inv_down(x: torch.Tensor, pre, dn, tp, blkinv, params: FieldParams,
             degree: int = 1, nr: int = 0) -> torch.Tensor:
    """bigmont_inv_down on the card: x, inv_up's arrays and the block
    products' inverses -> the inverses of x's lanes, (degree n32, n)."""
    _check_degree(degree, nr)
    check_words("bigmont_inv_down", params, x, degree=degree)
    check_words("bigmont_inv_down", params, pre, tp, blkinv,
                *([dn] if degree == 2 else []))
    x, pre, tp, blkinv = (t.contiguous() for t in (x, pre, tp, blkinv))
    dn = None if dn is None else dn.contiguous()
    out = torch.empty_like(x)
    _inv_call("bigmont_inv_down", params, degree, nr, x.shape[1], x, pre,
              dn, tp, blkinv, out)
    return out


def mont_batch_inv(x: torch.Tensor, params: FieldParams, degree: int = 1,
                   nr: int = 0) -> torch.Tensor:
    """1 / x lane by lane over (degree n32, *batch) words, a zero lane
    giving zero: degree 1 in the field, degree 2 in its quadratic
    extension u^2 = nr through the norm.  On the card THREE launches for
    any batch: bigmont_inv_up, bigmont_pow over the block products,
    bigmont_inv_down."""
    _check_degree(degree, nr)
    if x.device.type == "cpu":
        return mont_batch_inv_plain(x, params, degree, nr)
    check_words("bigmont_inv_up", params, x, degree=degree)
    flat = x.reshape(x.shape[0], -1)
    if flat.shape[1] == 0:
        return torch.empty_like(x)
    pre, dn, tp, blk = inv_up(flat, params, degree, nr)
    blkinv = _pow(blk, params.modulus - 2, params)
    return inv_down(flat, pre, dn, tp, blkinv, params, degree,
                    nr).reshape(x.shape)


def mont_mul(x: torch.Tensor, y: torch.Tensor,
             params: FieldParams) -> torch.Tensor:
    """x * y * R^-1 mod p lane by lane, batch shapes broadcast."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return mont_mul_plain(x, y, params)
    return _ew(x, y, params, 0)


def mont_sqr(x: torch.Tensor, params: FieldParams) -> torch.Tensor:
    """x^2 * R^-1 mod p lane by lane."""
    if x.device.type == "cpu":
        return mont_sqr_plain(x, params)
    return _ew(x, x, params, 1)


def mont_pow(x: torch.Tensor, e: int, params: FieldParams) -> torch.Tensor:
    """x^e lane by lane for a fixed exponent 0 <= e < 2^384, Montgomery
    form in and out: ONE launch for the whole chain."""
    if x.device.type == "cpu":
        return mont_pow_plain(x, e, params)
    return _pow(x, e, params)


class FieldKernels(NamedTuple):
    """The four field functions a BigMontField calls."""

    mul: Callable
    sqr: Callable
    pow: Callable
    batch_inv: Callable


#: what the entry points use: the kernels on CUDA tensors
KERNELS = FieldKernels(mont_mul, mont_sqr, mont_pow, mont_batch_inv)
#: the plain versions on any device, to hold the kernels against
PLAIN = FieldKernels(mont_mul_plain, mont_sqr_plain, mont_pow_plain,
                     mont_batch_inv_plain)
