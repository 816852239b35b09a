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
    return gl64.from_wire(rng.integers(0, 1 << 64, size=shape,
                                       dtype=np.uint64), dev)


@pytest.mark.parametrize("lg", [1, 7, 13])
def test_rows_kernel_vs_plain(dev, lg):
    rng = np.random.default_rng(lg)
    tw = get_parameters("goldilocks", dev).power_table(lg, False)
    x, mul = _raw(rng, dev, 2, 5, 1 << lg), _raw(rng, dev, 2, 5, 1 << lg)
    before = K.launches["gl64_ntt_rows"]
    for in_rev in (False, True):
        for out_rev in (False, True):
            for out_t in (False, True):
                for m in ((None,) if out_rev else (None, mul)):
                    args = (x, tw, lg, m, in_rev, out_rev, out_t)
                    got = K.ntt_rows(*args)
                    torch.cuda.synchronize()
                    assert torch.equal(got, K.ntt_rows_plain(*args)), args[3:]
    assert K.launches["gl64_ntt_rows"] == before + 12


@pytest.mark.parametrize("lg", [1, 6, 11])
def test_cols_kernel_vs_plain(dev, lg):
    rng = np.random.default_rng(lg)
    tw = get_parameters("goldilocks", dev).power_table(lg, True)
    x, mid = _raw(rng, dev, 3, 1 << lg, 64), _raw(rng, dev, 1 << lg, 64)
    for m in (None, mid):
        got = K.ntt_cols(x, tw, lg, m)
        torch.cuda.synchronize()
        assert torch.equal(got, K.ntt_cols_plain(x, tw, lg, m))


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
