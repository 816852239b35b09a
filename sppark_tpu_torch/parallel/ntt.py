"""The sharded NTT by the four-step (Bailey) decomposition: the port of
sppark_tpu/parallel/ntt.py onto torch.distributed.

N = N1 N2 viewed as the row-major (N1, N2) matrix A[i1][i2]:

  1. an N1-point NTT down every column   (local on a column shard)
  2. times the twiddles w^(i2 k1)        (each rank builds its own shard)
  3. an all-to-all: column to row shards (dist.all_to_all_single)
  4. an N2-point NTT along every row     (local)

gives D[k1][k2] = X[k1 + N1 k2].  `ntt_matrix_sharded` keeps the matrix
layout (a column shard in, a row shard out, one all-to-all);
`ntt_sharded` takes and gives the flat natural order, block-sharded
(three all-to-alls).

Every tensor is this rank's shard, in the field's word layout (ntt/core.py:
int64 Goldilocks words, int32 words of the 31-bit fields, (n32, ...)
words of a wide field), on the mesh's device.  The local NTTs run on the
port's own NTT kernels: the column NTTs and the twiddle product in one
pass of the column kernel (the twiddle shard its middle matrix; for a wide
field the column and middle-twiddle kernels, the shard factored), where
the columns fit it; else, and for the rows, the NTT path's one-pass,
four- or six-step (ntt/fused.py:fused_core), the long columns then
multiplied by the factored shard.  The inverse's 1/N rides in the twiddle
shard, as the JAX package scales once.  The shards live in the NTT
parameters' tables (ntt/parameters.py) until mesh.destroy().

`all_to_all_single` splits dim 0 of a contiguous tensor, where the JAX
package splits the matrix axes: each exchange puts the destination rank
first, then the word axis, then the chunk.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ntt.core import elem_ops
from ..ntt.fused import fused_core, fused_tables, mid_block
from ..ntt.kernels import KERNELS, LG_MAX, LG_MAX_WIDE
from ..ntt.parameters import get_parameters
from ..params import FieldParams
from .mesh import Mesh


def _name(field) -> str:
    return field.name if isinstance(field, FieldParams) else str(field)


def split(lg_n: int):
    """(lg N1, lg N2): N1 = 2^(lg // 2)."""
    lg1 = lg_n // 2
    return lg1, lg_n - lg1


def _local(field: str, x, lg: int, inverse: bool):
    """NTTs along the last axis through the port's NTT path, natural order
    in and out, without the inverse's 1/N (the twiddles carry it)."""
    if lg == 0:
        return x.clone()
    tables = fused_tables(field, lg, inverse, x.device, top=False)
    return fused_core(field, x, lg, inverse, tables, scale=False)


def _all_to_all(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Chunk j of dim 0 to rank j; chunk s of the result from rank s."""
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    return recv


def _to_rank_first(x: torch.Tensor, lead: int, D: int) -> torch.Tensor:
    """(lead, a, b) -> (D, lead, a, b / D), chunk j the columns
    [j b / D, (j + 1) b / D): a send buffer for `_all_to_all`."""
    b = x.shape[-1]
    return x.reshape(x.shape[:-1] + (D, b // D)).movedim(lead + 1,
                                                         0).contiguous()


def _body(field: str, a, lg_n: int, inverse: bool, mesh: Mesh):
    """Steps 1-4 on a column shard a (lead, N1, N2/D) -> the row shard
    (lead, N1/D, N2).  Columns of at most the column kernel's length go
    through it with the twiddle shard as its middle matrix (for a wide
    field its factored pair, the middle-twiddle kernel's); longer ones
    through the NTT path along the last axis, then the product by the
    factored pair, so no N-element shard is kept."""
    E = elem_ops(field)
    lead, D = E.lead, mesh.size
    lg1, lg2 = split(lg_n)
    m = a.shape[-1]
    pm = get_parameters(field, a.device)
    if 1 <= lg1 <= (LG_MAX_WIDE if E.factored_mid else LG_MAX):
        mid = pm.twiddle_shard(lg_n, lg1, inverse, D, mesh.rank,
                               mid_block(m) if E.factored_mid else 0)
        c = E.cols(KERNELS, a.contiguous(), pm.power_table(lg1, inverse),
                   lg1, mid)
    else:
        block = mid_block(m)
        A, B = pm.twiddle_shard(lg_n, lg1, inverse, D, mesh.rank, block)
        bt = _local(field, a.transpose(-1, -2).contiguous(), lg1, inverse)
        bt = bt.reshape(bt.shape[:-2] + (m // block, block, -1))
        bt = E.mul(E.mul(bt, A.transpose(-1, -2)[..., :, None, :]),
                   B.transpose(-1, -2)[..., None, :, :])
        c = bt.reshape(bt.shape[:-3] + (m, -1)).transpose(-1, -2)
    # column to row shards: rank j takes rows k1 of block j
    n1 = c.shape[-2]
    r = _all_to_all(c.reshape(c.shape[:lead] + (D, n1 // D, c.shape[-1]))
                    .movedim(lead, 0).contiguous(), mesh)  # (s, lead, k', i')
    r = r.movedim(0, lead + 1)                              # (lead, k', s, i')
    d = r.reshape(r.shape[:lead] + (n1 // D, -1))
    return _local(field, d, lg2, inverse)                   # row NTTs


def _check(field: str, x, lg_n: int, mesh: Mesh, shape) -> None:
    E = elem_ops(field)
    if x.ndim != E.lead + len(shape) or tuple(x.shape[E.lead:]) != shape:
        raise ValueError(f"this rank's shard must be {shape} (after "
                         f"{E.lead} word axes), not {tuple(x.shape)}")
    lg1, lg2 = split(lg_n)
    if (1 << lg1) % mesh.size or (1 << lg2) % mesh.size:
        raise ValueError(f"2^{lg1} and 2^{lg2} must be multiples of the "
                         f"mesh size {mesh.size}")


def ntt_matrix_sharded(field, a, lg_n: int, mesh: Mesh,
                       inverse: bool = False):
    """The four-step NTT keeping the matrix layout: `a` is this rank's
    column shard (lead, N1, N2/D) of the row-major (N1, N2) view of the
    natural-order vector (columns [rank N2/D, (rank + 1) N2/D)); returns
    its row shard (lead, N1/D, N2) of D[k1, k2] = X[k1 + N1 k2]."""
    name = _name(field)
    lg1, lg2 = split(lg_n)
    _check(name, a, lg_n, mesh, (1 << lg1, (1 << lg2) // mesh.size))
    return _body(name, a, lg_n, inverse, mesh)


def ntt_sharded(field, x, lg_n: int, mesh: Mesh, inverse: bool = False):
    """The NTT of a flat natural-order vector, block-sharded in and out:
    `x` is this rank's block (lead, N/D), elements [rank N/D, (rank + 1)
    N/D); returns the same block of the transform (three all-to-alls)."""
    name = _name(field)
    lead, D = elem_ops(name).lead, mesh.size
    lg1, lg2 = split(lg_n)
    n1, n2 = 1 << lg1, 1 << lg2
    _check(name, x, lg_n, mesh, ((1 << lg_n) // D,))
    # row shards of the (N1, N2) view to column shards
    r = _all_to_all(_to_rank_first(x.reshape(x.shape[:-1] + (n1 // D, n2)),
                                   lead, D), mesh)         # (s, lead, k', i')
    a = r.movedim(0, lead).reshape(r.shape[1:lead + 1] + (n1, n2 // D))
    e = _body(name, a, lg_n, inverse, mesh)                 # (lead, k1', k2)
    # X[k1 + N1 k2]: rank j holds k2 in block j, every k1
    r = _all_to_all(_to_rank_first(e, lead, D), mesh)  # (s, lead, k1', k2')
    r = r.permute(*range(1, lead + 1), lead + 2, 0, lead + 1)
    return r.reshape(r.shape[:lead] + (-1,))
