"""Twiddle tables (sppark ntt/parameters.cuh), built on the device they
are used on and cached per (field, device, lg, direction).

Layouts, chosen for the CUDA kernels:
  * power table [w^0 .. w^(n/2 - 1)]: both kernels read stage s's j-th
    twiddle at index j << (lg - s), so one compact table serves all stages;
  * middle twiddle matrix T[k1, i2] = w^(k1*i2), shape (N1, N2): the layout
    of the column pass's output, so the multiply fuses into that pass;
  * coset powers [g^0 .. g^(N-1)] (or g^-i), optionally bit-reversed.

Tables are built by doubling with plain field muls on the target device,
~one mul per element.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

from ..ff import gl64
from ..params import FieldParams, get_field
from .core import bit_reverse


def powers_of(base_int: int, n: int, device=None,
              mul_by: int = 1) -> torch.Tensor:
    """[c, c*w, c*w^2, ..., c*w^(n-1)] (c = mul_by) by doubling
    concatenation T_2m = [T_m, T_m * w^m]."""
    w = base_int % gl64.P
    acc = gl64.const(mul_by, (1,), device)
    k = 0
    while acc.shape[-1] < n:
        step = gl64.const(pow(w, 1 << k, gl64.P), (1,), device)
        acc = torch.cat([acc, gl64.mul(acc, step)], -1)
        k += 1
    return acc[:n].contiguous()


class NTTParameters:
    """Per-field, per-device twiddle cache (NTTParameters,
    parameters.cuh)."""

    def __init__(self, params: FieldParams, device: torch.device):
        self.params = params
        self.device = device
        self._tables: Dict[Tuple, torch.Tensor] = {}

    def _root(self, lg_domain: int, inverse: bool) -> int:
        return (self.params.inv_root_of_unity(lg_domain) if inverse
                else self.params.root_of_unity(lg_domain))

    def power_table(self, lg_domain: int, inverse: bool) -> torch.Tensor:
        """[w^0 .. w^(N/2 - 1)] for the primitive 2^lg root w."""
        key = ("pow", inverse, lg_domain)
        if key not in self._tables:
            n = max(1 << (lg_domain - 1), 1) if lg_domain else 1
            self._tables[key] = powers_of(self._root(lg_domain, inverse), n,
                                          self.device)
        return self._tables[key]

    def middle_twiddle_matrix(self, lg_domain: int, inverse: bool,
                              lg1: int) -> torch.Tensor:
        """(N1, N2) four-step twiddles T[k1, i2] = w^(k1*i2), N1 = 2^lg1,
        N2 = 2^(lg-lg1): rows [m, 2m) = rows [0, m) * P_m, P_2m = P_m^2."""
        key = ("mid", inverse, lg_domain, lg1)
        if key not in self._tables:
            n2 = 1 << (lg_domain - lg1)
            P = powers_of(self._root(lg_domain, inverse), n2,
                          self.device)[None, :]
            T = gl64.ones((1, n2), self.device)
            for _ in range(lg1):
                T = torch.cat([T, gl64.mul(T, P)], 0)
                P = gl64.sqr(P)
            self._tables[key] = T.contiguous()
        return self._tables[key]

    def scaled_middle_twiddle_matrix(self, lg_domain: int,
                                     lg1: int) -> torch.Tensor:
        """The inverse middle matrix with 1/N folded in: the inverse
        four-step's scale costs nothing extra this way."""
        key = ("mid_scaled", lg_domain, lg1)
        if key not in self._tables:
            scale = gl64.const(self.domain_size_inverse(lg_domain), (1, 1),
                               self.device)
            self._tables[key] = gl64.mul(
                self.middle_twiddle_matrix(lg_domain, True, lg1), scale)
        return self._tables[key]

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
                g = self.params.generator
                if inverse:
                    g = pow(g, gl64.P - 2, gl64.P)
                self._tables[key] = powers_of(g, 1 << lg_domain, self.device)
        return self._tables[key]


@functools.lru_cache(maxsize=None)
def _parameters(field_name: str, device: torch.device) -> NTTParameters:
    return NTTParameters(get_field(field_name), device)


def get_parameters(field_name: str, device=None) -> NTTParameters:
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _parameters(field_name, device)
