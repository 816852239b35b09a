"""Twiddle tables (sppark ntt/parameters.cuh), built on the device they
are used on and cached per (field, device, lg, direction).  Words are the
field's own: int64 Goldilocks words, or (n32, ...) Montgomery words of a
wide field, with the table's axes last.

Layouts, chosen for the CUDA kernels:
  * power table [w^0 .. w^(n/2 - 1)]: both kernels read stage s's j-th
    twiddle at index j << (lg - s), so one compact table serves all stages;
  * middle twiddle matrix T[k1, i2] = w^(k1*i2), shape (N1, N2): the layout
    of the column pass's output, so the Goldilocks multiply fuses into that
    pass;
  * the factored middle twiddles of the wide fields, T[k1, j] =
    A[k1, j / block] * B[k1, j mod block], A (N1, N2/block) and B (N1,
    block): O(sqrt n) words where T would be 2 GiB at lg 26;
  * coset powers [g^0 .. g^(N-1)] (or g^-i), optionally bit-reversed.

Tables are built by doubling with field muls on the target device (the
bigmont_ew kernel on a card for the wide fields), ~one mul per element.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..params import FieldParams, get_field
from .core import bit_reverse, elem_ops


def powers_of(E, base_int: int, n: int, device=None,
              mul_by: int = 1) -> torch.Tensor:
    """[c, c*w, c*w^2, ..., c*w^(n-1)] (c = mul_by) in the element ops E,
    by doubling concatenation T_2m = [T_m, T_m * w^m]."""
    p = E.params.modulus
    w = base_int % p
    acc = E.const(mul_by, (1,), device)
    k = 0
    while acc.shape[-1] < n:
        step = E.const(pow(w, 1 << k, p), (1,), device)
        acc = torch.cat([acc, E.mul(acc, step)], -1)
        k += 1
    return acc[..., :n].contiguous()


class NTTParameters:
    """Per-field, per-device twiddle cache (NTTParameters,
    parameters.cuh)."""

    def __init__(self, params: FieldParams, device: torch.device):
        self.params = params
        self.device = device
        self.E = elem_ops(params.name)
        self._tables: Dict[Tuple, torch.Tensor] = {}

    def _root(self, lg_domain: int, inverse: bool) -> int:
        return (self.params.inv_root_of_unity(lg_domain) if inverse
                else self.params.root_of_unity(lg_domain))

    def _scaled(self, t: torch.Tensor, lg_domain: int) -> torch.Tensor:
        """t * (1/N), N = 2^lg_domain."""
        scale = self.E.const(self.domain_size_inverse(lg_domain), (1, 1),
                             self.device)
        return self.E.mul(t, scale)

    def power_table(self, lg_domain: int, inverse: bool) -> torch.Tensor:
        """[w^0 .. w^(N/2 - 1)] for the primitive 2^lg root w."""
        key = ("pow", inverse, lg_domain)
        if key not in self._tables:
            n = max(1 << (lg_domain - 1), 1) if lg_domain else 1
            self._tables[key] = powers_of(self.E, self._root(lg_domain,
                                                             inverse),
                                          n, self.device)
        return self._tables[key]

    def _rows_by_doubling(self, root: int, n2: int, lg1: int):
        """(2^lg1, n2) matrix of root^(k1*i2): rows [m, 2m) = rows [0, m) *
        P_m, P_2m = P_m^2."""
        P = powers_of(self.E, root, n2, self.device)[..., None, :]
        T = self.E.ones((1, n2), self.device)
        for _ in range(lg1):
            T = torch.cat([T, self.E.mul(T, P)], -2)
            P = self.E.sqr(P)
        return T.contiguous()

    def middle_twiddle_matrix(self, lg_domain: int, inverse: bool,
                              lg1: int) -> torch.Tensor:
        """(N1, N2) four-step twiddles T[k1, i2] = w^(k1*i2), N1 = 2^lg1,
        N2 = 2^(lg-lg1)."""
        key = ("mid", inverse, lg_domain, lg1)
        if key not in self._tables:
            self._tables[key] = self._rows_by_doubling(
                self._root(lg_domain, inverse), 1 << (lg_domain - lg1), lg1)
        return self._tables[key]

    def scaled_middle_twiddle_matrix(self, lg_domain: int,
                                     lg1: int) -> torch.Tensor:
        """The inverse middle matrix with 1/N folded in: the inverse
        four-step's scale costs nothing extra this way."""
        key = ("mid_scaled", lg_domain, lg1)
        if key not in self._tables:
            self._tables[key] = self._scaled(
                self.middle_twiddle_matrix(lg_domain, True, lg1), lg_domain)
        return self._tables[key]

    def middle_twiddle_factored(self, lg_domain: int, inverse: bool,
                                lg1: int, block: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(A, B) with T[k1, j] = w^(k1*j) = A[k1, j / block] *
        B[k1, j mod block]: A[k1, b] = w^(k1*b*block), (N1, N2/block), and
        B[k1, t] = w^(k1*t), (N1, block).  Any block dividing N2 gives the
        same products."""
        n2 = 1 << (lg_domain - lg1)
        if n2 % block:
            raise ValueError(f"block {block} does not divide N2 = {n2}")
        key = ("midf", inverse, lg_domain, lg1, block)
        if key not in self._tables:
            root = self._root(lg_domain, inverse)
            self._tables[key] = (
                self._rows_by_doubling(pow(root, block, self.params.modulus),
                                      n2 // block, lg1),
                self._rows_by_doubling(root, block, lg1))
        return self._tables[key]

    def scaled_middle_twiddle_factored(self, lg_domain: int, lg1: int,
                                       block: int
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The inverse factored pair with 1/N folded into A."""
        key = ("midf_scaled", lg_domain, lg1, block)
        if key not in self._tables:
            A, B = self.middle_twiddle_factored(lg_domain, True, lg1, block)
            self._tables[key] = (self._scaled(A, lg_domain), B)
        return self._tables[key]

    def twiddle_shard(self, lg_domain: int, lg1: int, inverse: bool,
                      size: int, rank: int, block: int = 0):
        """Rank `rank` of `size`'s column shard of the middle twiddles
        T[k1, i2] = w^(k1*i2), columns [c0, c0 + M), M = N2/size, c0 =
        rank*M, for the sharded NTT (parallel/ntt.py): the (N1, M) matrix,
        or with `block` the factored pair (A, B), T[k1, c0 + j] =
        A[k1, j / block] * B[k1, j mod block].  The inverse's 1/N is
        folded in (into A).  Row k1 is (w^c0)^k1 times the powers of w^k1.
        Dropped with the process group (drop_twiddle_shards)."""
        key = ("shard", inverse, lg_domain, lg1, size, rank, block)
        if key not in self._tables:
            p = self.params.modulus
            w = self._root(lg_domain, inverse)
            m = (1 << (lg_domain - lg1)) // size
            col = powers_of(self.E, pow(w, rank * m, p), 1 << lg1,
                            self.device,
                            self.domain_size_inverse(lg_domain)
                            if inverse else 1)[..., :, None]
            if block:
                self._tables[key] = (
                    self.E.mul(self._rows_by_doubling(pow(w, block, p),
                                                      m // block, lg1), col),
                    self._rows_by_doubling(w, block, lg1))
            else:
                self._tables[key] = self.E.mul(
                    self._rows_by_doubling(w, m, lg1), col)
        return self._tables[key]

    def drop_twiddle_shards(self) -> None:
        for key in [k for k in self._tables if k[0] == "shard"]:
            del self._tables[key]

    def domain_size_inverse(self, lg_domain: int) -> int:
        return self.params.domain_size_inverse(lg_domain)

    def coset_powers(self, lg_domain: int, inverse: bool,
                     bitrev: bool = False) -> torch.Tensor:
        """[g^0, g^1, .. g^(N-1)] (or g^-i) for the coset shift;
        `bitrev=True` gives it in bit-reversed layout, for an array whose
        domain axis is itself in R order."""
        key = ("coset", inverse, lg_domain, bitrev)
        if key not in self._tables:
            if bitrev:
                nat = self.coset_powers(lg_domain, inverse)
                self._tables[key] = bit_reverse(nat, lg_domain)
            else:
                p = self.params.modulus
                g = self.params.generator
                if inverse:
                    g = pow(g, p - 2, p)
                self._tables[key] = powers_of(self.E, g, 1 << lg_domain,
                                              self.device)
        return self._tables[key]


_PARAMETERS: Dict[Tuple[str, torch.device], NTTParameters] = {}


def get_parameters(field_name: str, device=None) -> NTTParameters:
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (field_name, device)
    if key not in _PARAMETERS:
        _PARAMETERS[key] = NTTParameters(get_field(field_name), device)
    return _PARAMETERS[key]


def drop_twiddle_shards() -> None:
    """Free every field's and device's sharded-NTT twiddle shards: they
    belong to one process group's ranks."""
    for pm in _PARAMETERS.values():
        pm.drop_twiddle_shards()
