"""NTT facade (sppark ntt/ntt.cuh): InputOutputOrder {NN, NR, RN, RR},
Direction {forward, inverse}, Type {standard, coset}; `base` (host wire
array in and out, NTT::Base), `base_dev` (a tensor on its device,
NTT::Base_dev_ptr), and the LDE family (NTT::LDE_aux, LDE_powers,
LDE_expand).

Every NTT field of params.py is taken: Goldilocks words are int64 tensors
(*batch, n) and wire arrays of u64 (ff/gl64.py); the 31-bit fields'
(BabyBear, both generators) words are int32 tensors (*batch, n) of u32
Montgomery words and their wire arrays (*batch, n) u32 (ff/mont32.py); the
wide fields' words are (n32, *batch, n) int32 Montgomery words and their
wire arrays (*batch, n, n32) u32 (ff/bigmont.py), as the JAX package's
wire format.  Mersenne-31 has no NTT: its two-adicity is 1, and sppark
has none (its `max_lg_domain` is 0), so it is refused.

Host-array entry points take `device=None`, which means the CUDA card: on
a machine without one they raise unless the caller passes device="cpu".
The `*_dev` functions run on the device of the tensor they are given.
"""

from __future__ import annotations

import enum
from typing import Union

import numpy as np
import torch

from ..params import FieldParams, get_field
from ..runtime.devices import resolve
from ..util.errors import SpparkError
from . import fused
from .core import bit_reverse, bitrev_indices, elem_ops
from .parameters import get_parameters


class InputOutputOrder(enum.Enum):
    NN = "NN"
    NR = "NR"
    RN = "RN"
    RR = "RR"


class Direction(enum.Enum):
    forward = 0
    inverse = 1


class Type(enum.Enum):
    standard = 0
    coset = 1


def _field_name(field: Union[str, FieldParams]) -> str:
    return field.name if isinstance(field, FieldParams) else str(field)


def _check_field(name: str, lg: int) -> None:
    """An NTT field, and a domain within its two-adicity (the JAX package's
    limit; sppark's own MAX_LG_DOMAIN_SIZE, `max_lg_domain`, is lower)."""
    fp = get_field(name)
    if not fp.max_lg_domain:
        raise SpparkError(1, f"{name}: no NTT over this field")
    if lg > fp.two_adicity:
        raise SpparkError(1, f"{name}: 2^{lg} exceeds two-adicity")


def _check_domain(name: str, x: torch.Tensor, lg: int) -> None:
    _check_field(name, lg)
    if x.shape[-1] != 1 << lg:
        raise ValueError(f"last axis {x.shape[-1]} != 2^{lg}")
    E = elem_ops(name)
    n32 = get_field(name).n_ref_limbs
    if x.dtype != E.dtype or x.shape[:E.lead] != (n32,) * E.lead:
        got = ("int64 Goldilocks words" if x.dtype == torch.int64
               else f"{x.dtype} {tuple(x.shape)}")
        raise SpparkError(1, f"{name} takes {E.words}, not {got}")


def _from_wire(name: str, arr: np.ndarray, device) -> torch.Tensor:
    return elem_ops(name).from_wire(arr, resolve(device))


def _to_wire(name: str, t: torch.Tensor) -> np.ndarray:
    return elem_ops(name).to_wire(t)


def base_dev(field, x: torch.Tensor, lg_domain: int,
             order: InputOutputOrder = InputOutputOrder.NN,
             direction: Direction = Direction.forward,
             ntt_type: Type = Type.standard) -> torch.Tensor:
    """NTT along the last axis of a tensor of the field's words, on its
    device (NTT::Base_dev_ptr)."""
    name = _field_name(field)
    _check_domain(name, x, lg_domain)
    return fused.facade(name, x, lg_domain, InputOutputOrder(order).value,
                        Direction(direction) == Direction.inverse,
                        Type(ntt_type) == Type.coset)


def base(field, inout: np.ndarray, lg_domain: int,
         order: InputOutputOrder = InputOutputOrder.NN,
         direction: Direction = Direction.forward,
         ntt_type: Type = Type.standard, device=None) -> np.ndarray:
    """One-shot host-array NTT (NTT::Base): upload, transform, download,
    in the wire format."""
    name = _field_name(field)
    x = _from_wire(name, inout, device)
    return _to_wire(name, base_dev(name, x, lg_domain, order, direction,
                                   ntt_type))


def ntt(field, inout, lg_domain, order=InputOutputOrder.NN, device=None):
    return base(field, inout, lg_domain, order, Direction.forward,
                device=device)


def intt(field, inout, lg_domain, order=InputOutputOrder.NN, device=None):
    return base(field, inout, lg_domain, order, Direction.inverse,
                device=device)


def coset_ntt(field, inout, lg_domain, order=InputOutputOrder.NN,
              device=None):
    return base(field, inout, lg_domain, order, Direction.forward,
                Type.coset, device=device)


def coset_intt(field, inout, lg_domain, order=InputOutputOrder.NN,
               device=None):
    return base(field, inout, lg_domain, order, Direction.inverse,
                Type.coset, device=device)


# -- LDE -----------------------------------------------------------------------

def _check_lde(name: str, x: torch.Tensor, lg: int, lg_blowup: int) -> None:
    _check_domain(name, x, lg)
    _check_field(name, lg + lg_blowup)


def lde_dev(field, x: torch.Tensor, lg_domain: int,
            lg_blowup: int) -> torch.Tensor:
    """Low-degree extension: 2^lg evaluations over H -> 2^(lg + blowup)
    evaluations over the coset g*H' (NTT::LDE_aux without the aux copy)."""
    name = _field_name(field)
    _check_lde(name, x, lg_domain, lg_blowup)
    return fused.lde(name, x, lg_domain, lg_blowup)


def lde_aux_dev(field, x: torch.Tensor, lg_domain: int, lg_blowup: int):
    """LDE returning (extended evaluations, coefficients)."""
    name = _field_name(field)
    _check_lde(name, x, lg_domain, lg_blowup)
    return fused.lde(name, x, lg_domain, lg_blowup, aux=True)


def lde(field, inout: np.ndarray, lg_domain: int, lg_blowup: int,
        device=None) -> np.ndarray:
    name = _field_name(field)
    x = _from_wire(name, inout, device)
    return _to_wire(name, lde_dev(name, x, lg_domain, lg_blowup))


def lde_powers_dev(field, x: torch.Tensor, lg_domain: int,
                   bitrev: bool = True) -> torch.Tensor:
    """x[i] * g^bitrev(i) (NTT::LDE_powers); natural i with bitrev=False."""
    name = _field_name(field)
    table = get_parameters(name, x.device).coset_powers(lg_domain, False,
                                                        bitrev=bitrev)
    return fused.domain_mul(elem_ops(name), x, table)


def lde_expand_dev(field, x: torch.Tensor, lg_domain: int,
                   lg_blowup: int) -> torch.Tensor:
    """Spread bit-reversed coefficients into the blown-up bit-reversed
    domain without the coset shift: the value at i lands at i << blowup,
    zeros between (NTT::LDE_expand)."""
    out = torch.zeros(x.shape + (1 << lg_blowup,), dtype=x.dtype,
                      device=x.device)
    out[..., 0] = x
    return out.reshape(x.shape[:-1] + (1 << (lg_domain + lg_blowup),))


__all__ = [
    "InputOutputOrder", "Direction", "Type",
    "base", "base_dev", "ntt", "intt", "coset_ntt", "coset_intt",
    "lde", "lde_dev", "lde_aux_dev", "lde_powers_dev", "lde_expand_dev",
    "bit_reverse", "bitrev_indices",
]
