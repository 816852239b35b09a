"""`correct` must come out false for the control and for each fault the
cells can have, and true for the program as it is; at the small sizes of
small.py, on the CPU, with the harness's look for a card skipped."""

import pytest
import torch

from benchmark.core.spec import load_kind
from benchmark.tests.small import run_small, small_cell

TRANSFORMS = ["goldilocks.ntt", "goldilocks.lde", "bls12_381.lde_fr"]
MSM = "bls12_381.msm_g1"
Transform, MSMLoad = load_kind("transform"), load_kind("msm")


@pytest.mark.parametrize("name", TRANSFORMS + [MSM])
def test_control_reads_not_correct(name):
    load = small_cell(name).make_load(31337, "cpu")
    load.make_inputs()
    numbers = load.control_numbers()
    assert all(v > 0 for v in numbers.values()), numbers


@pytest.mark.parametrize("name", TRANSFORMS + [MSM])
def test_program_reads_correct(name):
    r = run_small(name)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"


class _Unchanged(Transform):
    """A step that returns its state unchanged: the input comes back."""

    def call(self, slot):
        return self.ring[slot].clone()


class _HalfBatch(Transform):
    """Half of each batch left out: those calls return zeros."""

    def call(self, slot):
        out = super().call(slot)
        return torch.zeros_like(out) if slot % 2 else out


class _Altered(Transform):
    """One word of one answer altered where it is produced."""

    def call(self, slot):
        out = super().call(slot)
        if slot == 1:
            out[..., 5] ^= 1
        return out


class _Swapped(Transform):
    """Two answers of a batch swapped."""

    def call(self, slot):
        return super().call(slot ^ 1)


@pytest.mark.parametrize("fault", [_Unchanged, _HalfBatch, _Altered,
                                   _Swapped])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_faults_read_not_correct(name, fault):
    r = run_small(name, load=fault)
    assert not r["correct"] and r["checks"]["words_wrong"]["value"] > 0


class _MSMUnchanged(MSMLoad):
    """The accumulation left at its initial state: the point at
    infinity comes back."""

    def call(self, slot):
        pt = super().call(slot)
        pt.x, pt.y, pt.inf = 0, 0, True
        return pt


class _MSMHalf(MSMLoad):
    """Half of the terms left out: the second half's scalars zeroed."""

    def call(self, slot):
        w = self.scalars[slot].clone()
        w[:, w.shape[1] // 2:] = 0
        return self.ctx.invoke(w)


class _MSMAltered(MSMLoad):
    """The answer altered where it is produced."""

    def call(self, slot):
        pt = super().call(slot)
        pt.x = (pt.x + 1) % self.curve.p
        return pt


@pytest.mark.parametrize("fault", [_MSMUnchanged, _MSMHalf, _MSMAltered])
def test_msm_faults_read_not_correct(fault):
    r = run_small(MSM, load=fault)
    assert not r["correct"] and r["checks"]["points_wrong"]["value"] > 0
