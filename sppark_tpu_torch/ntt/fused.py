"""NTT orchestration over the kernels: one row pass, the four-step and
the six-step, with the facade's orders, directions and coset shift (the
port of sppark_tpu/ntt/pallas_kernels.py:_fused_core, _fused_tables,
_scaled_mid, _factored_mid, _split_lg1, _tile_cap, _apply_mid_factored,
coset_shift_bitrev and fused_facade_fn).

  * lg <= the tile cap: one row pass.  The R orders are free: the kernel
    skips its input bit reversal (R input) or adds an output one (R output).
  * tile cap < lg <= column cap + tile cap: four-step.  View x as
    (N1, N2); the column pass runs N1-point NTTs down the columns and the
    middle twiddles T[k1, i2] = w^(k1*i2) multiply its output; the row
    pass runs N2-point NTTs and stores transposed, so the flat result is
    already X[k1 + N1*k2].  For the inverse, 1/N is folded into T.
  * above that, six-step: the row side is itself a four-step over a batch
    of rows, followed by one plain transpose.  Only the top level scales.

Goldilocks and the 31-bit fields (BabyBear) multiply the (N1, N2) matrix
T inside the column pass, and share the caps: a 2^13 tile and 2^11-point
columns, as the JAX package has them for every field that is not wide
(at lg 24 the mont32 T is 64 MiB of u32).  The wide fields keep T
factored, A (N1, N2/block) times B (N1, block), and multiply it in a pass
of its own (wide_mid), as the TPU does: T would be 2 GiB at lg 26.  Their
caps are their own: a wide tile is 2^11 elements (64 KiB of 32-byte
elements), and 2^8-point columns leave 8 columns in a tile, so each row
read fills a 32-byte sector.

Above the tile cap the R orders take standalone `bit_reverse` passes.  The
caps are read from this module at call time, so tests can lower them to
reach the four-step and six-step at small sizes.

Every function takes `kern`, the kernel functions to call: kernels.KERNELS
(the default, what the entry points use) or kernels.PLAIN (the plain
versions, to hold the kernels against on the same device).  Arrays hold
the field's words with the domain last: (*batch, n) int64 for Goldilocks,
(*batch, n) int32 for the 31-bit fields, (n32, *batch, n) int32 for the
wide fields.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .core import bit_reverse, elem_ops
from .kernels import KERNELS, Kernels
from .parameters import get_parameters

#: longest transform one Goldilocks or mont32 row pass takes (kernels.LG_MAX
#: or less)
LG_TILE = 13
#: longest Goldilocks or mont32 column of the four-step: 2^11 columns keep
#: the six-step's inner transforms inside one row pass up to lg 24 + 11
LG_COL_CAP = 11
#: the same for the wide fields (kernels.LG_MAX_WIDE or less)
LG_TILE_WIDE = 11
LG_COL_CAP_WIDE = 8


def tile_cap(field: str) -> int:
    return LG_TILE_WIDE if elem_ops(field).factored_mid else LG_TILE


def split_lg1(lg: int, field: str) -> int:
    """Column length of the four/six-step split."""
    cap = LG_COL_CAP_WIDE if elem_ops(field).factored_mid else LG_COL_CAP
    return min(lg // 2, cap)


def mid_block(n2: int) -> int:
    """Column-block width of the wide fields' factored middle twiddles:
    ~sqrt(N2), which keeps A and B smallest."""
    return 1 << ((n2.bit_length() - 1) // 2)


def fused_tables(field: str, lg: int, inverse: bool, device,
                 top: bool = True) -> Tuple:
    """(tw,) for one row pass; (tw(lg1), mid, tw(lg2)) for the four-step;
    (tw(lg1), mid, *fused_tables(lg2, top=False)) for the six-step.  `mid`
    is the (N1, N2) matrix, or the factored (A, B) for a wide field.  Only
    the top level's inverse middle twiddles carry 1/N."""
    pm = get_parameters(field, device)
    if lg <= tile_cap(field):
        return (pm.power_table(lg, inverse),)
    lg1 = split_lg1(lg, field)
    lg2 = lg - lg1
    if elem_ops(field).factored_mid:
        block = mid_block(1 << lg2)
        mid = (pm.scaled_middle_twiddle_factored(lg, lg1, block)
               if inverse and top else
               pm.middle_twiddle_factored(lg, inverse, lg1, block))
    elif inverse and top:
        mid = pm.scaled_middle_twiddle_matrix(lg, lg1)
    else:
        mid = pm.middle_twiddle_matrix(lg, inverse, lg1)
    head = (pm.power_table(lg1, inverse), mid)
    if lg2 <= tile_cap(field):
        return head + (pm.power_table(lg2, inverse),)
    return head + fused_tables(field, lg2, inverse, device, top=False)


def _batched(x, lead: int, keep: int):
    """x with its batch axes collapsed into one, the `lead` word axes in
    front and the last `keep` axes kept."""
    shape = x.shape
    return x.reshape(shape[:lead] + (-1,) + shape[len(shape) - keep:]
                     ).contiguous()


def _apply_rows_t(kern: Kernels, field: str, x, lg: int, tw):
    """Row pass over (.., B, n) with the transposed store: (.., n, B).
    Leading batch axes collapse into the kernel's outer batch."""
    shape = x.shape
    E = elem_ops(field)
    y = E.rows(kern, _batched(x, E.lead, 2), tw, lg, out_t=True)
    return y.reshape(shape[:-2] + (shape[-1], shape[-2]))


def _apply_cols(kern: Kernels, field: str, x, lg: int, tw, mid):
    """Column pass over (.., n1, M) times the middle twiddles; leading
    batch axes collapse into the kernel's batch."""
    E = elem_ops(field)
    return E.cols(kern, _batched(x, E.lead, 2), tw, lg, mid).reshape(x.shape)


def fused_core(field: str, x, lg: int, inverse: bool, tables,
               in_rev: bool = True, out_rev: bool = False,
               scale: bool = True, kern: Kernels = KERNELS):
    """NTT along the last axis of x, natural order in and out unless
    `in_rev=False` (bit-reversed input) or `out_rev=True` (bit-reversed
    output), which only one row pass offers.  `scale=False` leaves out the
    inverse's 1/N (the sub-transforms of the six-step)."""
    E = elem_ops(field, kern.field)
    if lg <= tile_cap(field):
        (tw,) = tables
        out = E.rows(kern, _batched(x, E.lead, 1), tw, lg, in_rev=in_rev,
                     out_rev=out_rev).reshape(x.shape)
        if inverse and scale:
            inv_n = get_parameters(field, x.device).domain_size_inverse(lg)
            out = E.mul(out, E.const(inv_n, (1,) * (x.ndim - E.lead),
                                     x.device))
        return out
    if not in_rev or out_rev:
        raise ValueError("R orders above the tile cap take standalone "
                         "bit_reverse passes")
    lg1 = split_lg1(lg, field)
    lg2 = lg - lg1
    a = x.reshape(x.shape[:-1] + (1 << lg1, 1 << lg2))
    c = _apply_cols(kern, field, a, lg1, tables[0], tables[1])  # (.., k1, i2)
    if lg2 <= tile_cap(field):
        out = _apply_rows_t(kern, field, c, lg2, tables[2])     # (.., k2, k1)
        return out.reshape(x.shape)
    d = fused_core(field, c, lg2, inverse, tables[2:], scale=False,
                   kern=kern)                                   # (.., k1, k2)
    return d.transpose(-1, -2).reshape(x.shape)


def coset_shift_bitrev(field: str, lg: int, order: str,
                       inverse: bool) -> bool:
    """True when the coset shift table must be bit-reversed to match the
    array it multiplies: the forward shift multiplies the input, which is
    in R layout iff the input order is R; the inverse shift multiplies the
    output, which is natural except where one row pass emits R directly."""
    if not inverse:
        return order[0] == "R"
    return lg <= tile_cap(field) and order[1] == "R"


def domain_mul(E, x, table):
    """x times the coset table (the domain axis) over every batch axis."""
    t = table.reshape(table.shape[:E.lead] + (1,) * (x.ndim - table.ndim)
                      + table.shape[E.lead:])
    return E.mul(x, t)


def facade(field: str, x, lg: int, order: str = "NN", inverse: bool = False,
           coset: bool = False, kern: Kernels = KERNELS):
    """The full facade: orders NN/NR/RN/RR, forward/inverse, standard or
    coset, along the last axis of x on x's device."""
    E = elem_ops(field, kern.field)
    if lg == 0:
        return E.canon(x)
    tables = fused_tables(field, lg, inverse, x.device)
    shift = None
    if coset:
        shift = get_parameters(field, x.device).coset_powers(
            lg, inverse, bitrev=coset_shift_bitrev(field, lg, order, inverse))
    in_r, out_r = order[0] == "R", order[1] == "R"
    if coset and not inverse:
        x = domain_mul(E, x, shift)
    if lg <= tile_cap(field):
        y = fused_core(field, x, lg, inverse, tables, in_rev=not in_r,
                       out_rev=out_r, kern=kern)
        return domain_mul(E, y, shift) if coset and inverse else y
    if in_r:
        x = bit_reverse(x, lg)
    y = fused_core(field, x, lg, inverse, tables, kern=kern)
    if coset and inverse:
        y = domain_mul(E, y, shift)
    return bit_reverse(y, lg) if out_r else y


def lde(field: str, x, lg: int, lg_blowup: int, aux: bool = False,
        kern: Kernels = KERNELS):
    """Low-degree extension along the last axis: iNTT the 2^lg evaluations,
    zero-extend the coefficients to 2^(lg + lg_blowup), shift onto the
    coset, forward NTT.  With `aux`, returns (extension, coefficients)."""
    E = elem_ops(field, kern.field)
    lg_ext = lg + lg_blowup
    dev = x.device
    if lg == 0:
        coeffs = E.canon(x)
    else:
        coeffs = fused_core(field, x, lg, True,
                            fused_tables(field, lg, True, dev), kern=kern)
    pad = torch.zeros(coeffs.shape[:-1] + ((1 << lg_ext) - (1 << lg),),
                      dtype=coeffs.dtype, device=dev)
    ext = domain_mul(E, torch.cat([coeffs, pad], -1),
                 get_parameters(field, dev).coset_powers(lg_ext, False))
    out = (fused_core(field, ext, lg_ext, False,
                      fused_tables(field, lg_ext, False, dev), kern=kern)
           if lg_ext else ext)
    return (out, coeffs) if aux else out
