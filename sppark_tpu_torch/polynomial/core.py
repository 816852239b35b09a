"""Prefix-scan shaped polynomial ops on word tensors: the port of
sppark_tpu/polynomial/core.py.

Arrays hold a field's words with the degree (or point) axis last, in the
layouts of the NTT (ntt/core.py): Goldilocks int64 words (*batch, n), the
31-bit fields' int32 Montgomery words (*batch, n), the wide fields'
(n32, *batch, n) int32 Montgomery words.  Every op is canonical in and
out, so the words equal the JAX package's whatever order the scans
combine in.

The scans are the port's Hillis-Steele `scan` (ff/inversion.py): lg(n)
steps, each one field op over the whole array.  A wide field's products
go through the field kernels `kern` (ff/kernels.py): the bigmont_ew kernel
on a CUDA tensor, the plain product on a CPU tensor; `kern=ff.kernels.
PLAIN` runs the plain product on any device.  The 64- and 32-bit fields
have no kernel here: the JAX package leaves their ops to XLA.
"""

from __future__ import annotations

import torch

from ..ff import kernels as FK
from ..ff.inversion import scan
from ..ntt.core import elem_ops
from ..params import FieldParams

#: per-pass live-element budget of evaluate (n * B): B points a pass, as
#: the reference bounds it with its points-per-pass template
#: (evaluate.cuh:330)
_EVAL_PASS_ELEMS = 1 << 22


def _ops(field, kern: FK.FieldKernels):
    """The element ops of a field (ntt/core.py:elem_ops): canonical `add`
    and `mul` over its words, `lead` its leading word axes."""
    return elem_ops(field.name if isinstance(field, FieldParams)
                    else str(field), kern)


# -- prefix_op (polynomial/prefix_op.cuh) ---------------------------------------

def prefix_op(field, x, op: str = "add", kern: FK.FieldKernels = FK.KERNELS):
    """Inclusive prefix scan along the last axis; `op` is "add" or
    "multiply" (the Add/Multiply templates, prefix_op.cuh:18-47)."""
    if op not in ("add", "multiply"):
        raise ValueError(f"op must be add|multiply, got {op!r}")
    F = _ops(field, kern)
    return scan(F.add if op == "add" else F.mul, x)


def prefix_sum(field, x, kern: FK.FieldKernels = FK.KERNELS):
    return prefix_op(field, x, "add", kern)


def prefix_product(field, x, kern: FK.FieldKernels = FK.KERNELS):
    return prefix_op(field, x, "multiply", kern)


# -- div_by_x_minus_z (polynomial/div_by_x_minus_z.cuh) -------------------------

def div_by_x_minus_z(field, coeffs, z, rotate: bool = False,
                     kern: FK.FieldKernels = FK.KERNELS):
    """Divide sum_i c_i x^i (the last axis) by (x - z); `z` is a field
    element that broadcasts against `coeffs` (batch shape (1,), say).

    d_k = c_k + z d_{k+1}, d_n = 0: quotient q_k = d_{k+1}, remainder
    p(z) = d_0, as a reverse scan over (value, z-power) pairs; a and b the
    segments nearer the high- and the low-degree end, V = v_b + p_b v_a
    and P = p_a p_b (div_by_x_minus_z.cuh:41-121).

    rotate=False: (quotient zero-padded to n, remainder p(z)).
    rotate=True : one array [remainder, quotient...], the reference's
    in-place layout."""
    F = _ops(field, kern)
    zb = torch.broadcast_to(z, coeffs.shape)

    def combine(lo, hi):
        # scan(reverse=True) combines (lo, hi) = (b, a)
        (v_b, p_b), (v_a, p_a) = lo, hi
        return torch.stack([F.add(v_b, F.mul(p_b, v_a)), F.mul(p_a, p_b)])

    d = scan(combine, torch.stack([coeffs, zb]), reverse=True)[0]
    # d[k] = sum_{j >= k} c_j z^(j - k): remainder d[0], quotient d[1:]
    if rotate:
        return d
    return (torch.cat([d[..., 1:], torch.zeros_like(d[..., :1])], dim=-1),
            d[..., :1])


# -- evaluate (polynomial/evaluate.cuh) -------------------------------------------

def _tree_sum(F, acc):
    """Sum along the last axis by halving, an odd tail carried along."""
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        s = F.add(acc[..., :half], acc[..., half:2 * half])
        acc = torch.cat([s, acc[..., 2 * half:]], dim=-1)
    return acc[..., 0]


def evaluate(field, coeffs, xs, kern: FK.FieldKernels = FK.KERNELS,
             pass_elems: int = _EVAL_PASS_ELEMS):
    """p(x) at each point of `xs` (last axis: points) for the polynomial
    `coeffs` (last axis: degree); the other axes broadcast.  Each point's
    powers x^0 .. x^(n-1) come from a prefix product of x (the powers-of-x
    scan, evaluate.cuh) and the terms' sum from a halving tree (the
    per-warp redux, evaluate.cuh:32-47); the result is (lead, *batch,
    npts), the batch axes of both broadcast.  B = pass_elems // n points run
    together, so live memory stays O(n B) (evaluate.cuh:330-333)."""
    F = _ops(field, kern)
    lead = F.lead
    n, npts = coeffs.shape[-1], xs.shape[-1]
    B = max(1, min(npts, pass_elems // max(n, 1)))
    # the batch axes (between the word axes and the last) broadcast
    nb = max(coeffs.ndim, xs.ndim) - lead - 1
    coeffs, xs = (t.reshape(t.shape[:lead] + (1,) * (nb + lead + 1 - t.ndim)
                            + t.shape[lead:]) for t in (coeffs, xs))
    c = coeffs[..., None, :]                    # (lead, *batch, 1, n)
    c0 = coeffs[..., None, :1]
    outs = []
    for lo in range(0, npts, B):
        x = xs[..., lo:lo + B, None]            # (lead, *batch, B, 1)
        shape = torch.broadcast_shapes(x.shape[:-1] + (n,), c.shape)
        # pows[j] = x^(j + 1); the terms take x^j, c_0 alone
        pows = scan(F.mul, x.expand(shape).contiguous())
        terms = F.mul(c[..., 1:], pows[..., :-1])
        outs.append(_tree_sum(F, torch.cat(
            [c0.expand(shape[:-1] + (1,)), terms], dim=-1)))
    return torch.cat(outs, dim=-1)
