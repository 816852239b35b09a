"""NTT orchestration over the two kernels: one row pass, the four-step and
the six-step, with the facade's orders, directions and coset shift (the
port of sppark_tpu/ntt/pallas_kernels.py:_fused_core, _fused_tables,
_scaled_mid, _split_lg1, coset_shift_bitrev and fused_facade_fn).

  * lg <= LG_TILE: one row pass.  The R orders are free: the kernel skips
    its input bit reversal (R input) or adds an output one (R output).
  * LG_TILE < lg <= LG_COL_CAP + LG_TILE: four-step.  View x as (N1, N2);
    the column pass runs N1-point NTTs down the columns and multiplies by
    the middle twiddles T[k1, i2] = w^(k1*i2) in the same pass; the row pass
    runs N2-point NTTs and stores transposed, so the flat result is already
    X[k1 + N1*k2].  For the inverse, 1/N is folded into T.
  * above that, six-step: the row side is itself a four-step over a batch
    of rows, followed by one plain transpose.  Only the top level scales.

Above LG_TILE the R orders take standalone `bit_reverse` passes.  The caps
are read from this module at call time, so tests can lower them to reach
the four-step and six-step at small sizes.

Every function takes `kern`, the pair of kernel functions to call:
kernels.KERNELS (the default, what the entry points use) or kernels.PLAIN
(the plain versions, to hold the kernels against on the same device).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ff import gl64
from .core import bit_reverse
from .kernels import KERNELS, Kernels
from .parameters import get_parameters

#: longest transform one row pass takes (kernels.LG_MAX or less)
LG_TILE = 13
#: longest column of the four-step: 2^11 columns keep the six-step's inner
#: transforms inside one row pass up to lg 24 + 11
LG_COL_CAP = 11


def split_lg1(lg: int) -> int:
    """Column length of the four/six-step split."""
    return min(lg // 2, LG_COL_CAP)


def fused_tables(field: str, lg: int, inverse: bool, device,
                 top: bool = True) -> Tuple[torch.Tensor, ...]:
    """(tw,) for one row pass; (tw(lg1), mid, tw(lg2)) for the four-step;
    (tw(lg1), mid, *fused_tables(lg2, top=False)) for the six-step.  Only
    the top level's inverse middle matrix carries 1/N."""
    pm = get_parameters(field, device)
    if lg <= LG_TILE:
        return (pm.power_table(lg, inverse),)
    lg1 = split_lg1(lg)
    lg2 = lg - lg1
    if inverse and top:
        mid = pm.scaled_middle_twiddle_matrix(lg, lg1)
    else:
        mid = pm.middle_twiddle_matrix(lg, inverse, lg1)
    head = (pm.power_table(lg1, inverse), mid)
    if lg2 <= LG_TILE:
        return head + (pm.power_table(lg2, inverse),)
    return head + fused_tables(field, lg2, inverse, device, top=False)


def _apply_rows_t(kern: Kernels, x, lg: int, tw):
    """Row pass over (.., B, n) with the transposed store: (.., n, B).
    Leading dims collapse into the kernel's outer batch."""
    shape = x.shape
    y = kern.rows(x.reshape(-1, shape[-2], shape[-1]).contiguous(), tw, lg,
                  out_t=True)
    return y.reshape(shape[:-2] + (shape[-1], shape[-2]))


def _apply_cols(kern: Kernels, x, lg: int, tw, mid):
    """Column pass over (.., n1, M) times the middle matrix; leading dims
    collapse into the kernel's batch."""
    shape = x.shape
    y = kern.cols(x.reshape(-1, shape[-2], shape[-1]).contiguous(), tw, lg,
                  mid)
    return y.reshape(shape)


def fused_core(field: str, x, lg: int, inverse: bool, tables,
               in_rev: bool = True, out_rev: bool = False,
               scale: bool = True, kern: Kernels = KERNELS):
    """NTT along the last axis of x (.., 2^lg), natural order in and out
    unless `in_rev=False` (bit-reversed input) or `out_rev=True`
    (bit-reversed output), which only one row pass offers.  `scale=False`
    leaves out the inverse's 1/N (the sub-transforms of the six-step)."""
    n = 1 << lg
    if lg <= LG_TILE:
        (tw,) = tables
        out = kern.rows(x.reshape(-1, n).contiguous(), tw, lg,
                        in_rev=in_rev, out_rev=out_rev).reshape(x.shape)
        if inverse and scale:
            inv_n = get_parameters(field, x.device).domain_size_inverse(lg)
            out = gl64.mul(out, gl64.const(inv_n, (1,), x.device))
        return out
    if not in_rev or out_rev:
        raise ValueError("R orders above LG_TILE take standalone "
                         "bit_reverse passes")
    lg1 = split_lg1(lg)
    lg2 = lg - lg1
    a = x.reshape(x.shape[:-1] + (1 << lg1, 1 << lg2))
    c = _apply_cols(kern, a, lg1, tables[0], tables[1])     # (.., k1, i2)
    if lg2 <= LG_TILE:
        out = _apply_rows_t(kern, c, lg2, tables[2])         # (.., k2, k1)
        return out.reshape(x.shape)
    d = fused_core(field, c, lg2, inverse, tables[2:], scale=False,
                   kern=kern)                                # (.., k1, k2)
    return d.transpose(-1, -2).reshape(x.shape)


def coset_shift_bitrev(lg: int, order: str, inverse: bool) -> bool:
    """True when the coset shift table must be bit-reversed to match the
    array it multiplies: the forward shift multiplies the input, which is
    in R layout iff the input order is R; the inverse shift multiplies the
    output, which is natural except where one row pass emits R directly."""
    if not inverse:
        return order[0] == "R"
    return lg <= LG_TILE and order[1] == "R"


def facade(field: str, x, lg: int, order: str = "NN", inverse: bool = False,
           coset: bool = False, kern: Kernels = KERNELS):
    """The full facade: orders NN/NR/RN/RR, forward/inverse, standard or
    coset, along the last axis of x on x's device."""
    if lg == 0:
        return gl64.canon(x)
    tables = fused_tables(field, lg, inverse, x.device)
    shift = None
    if coset:
        shift = get_parameters(field, x.device).coset_powers(
            lg, inverse, bitrev=coset_shift_bitrev(lg, order, inverse))
    in_r, out_r = order[0] == "R", order[1] == "R"
    if coset and not inverse:
        x = gl64.mul(x, shift)
    if lg <= LG_TILE:
        y = fused_core(field, x, lg, inverse, tables, in_rev=not in_r,
                       out_rev=out_r, kern=kern)
        return gl64.mul(y, shift) if coset and inverse else y
    if in_r:
        x = bit_reverse(x, lg)
    y = fused_core(field, x, lg, inverse, tables, kern=kern)
    if coset and inverse:
        y = gl64.mul(y, shift)
    return bit_reverse(y, lg) if out_r else y


def lde(field: str, x, lg: int, lg_blowup: int, aux: bool = False,
        kern: Kernels = KERNELS):
    """Low-degree extension along the last axis: iNTT the 2^lg evaluations,
    zero-extend the coefficients to 2^(lg + lg_blowup), shift onto the
    coset, forward NTT.  With `aux`, returns (extension, coefficients)."""
    lg_ext = lg + lg_blowup
    dev = x.device
    if lg == 0:
        coeffs = gl64.canon(x)
    else:
        coeffs = fused_core(field, x, lg, True,
                            fused_tables(field, lg, True, dev), kern=kern)
    pad = torch.zeros(coeffs.shape[:-1] + ((1 << lg_ext) - (1 << lg),),
                      dtype=torch.int64, device=dev)
    ext = gl64.mul(torch.cat([coeffs, pad], -1),
                   get_parameters(field, dev).coset_powers(lg_ext, False))
    out = (fused_core(field, ext, lg_ext, False,
                      fused_tables(field, lg_ext, False, dev), kern=kern)
           if lg_ext else ext)
    return (out, coeffs) if aux else out
