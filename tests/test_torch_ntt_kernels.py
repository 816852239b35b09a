"""The plain versions of the port's NTT kernels (sppark_tpu_torch.ntt.kernels)
against the Pallas kernels they replace, run by the Pallas interpreter on
the CPU, on the same words and the JAX package's own twiddle tables carried
across with gl64.from_jax_planes.  Comparison is exact.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py
and chip_smoke.py hold them against these plain versions)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sppark_tpu.ntt import pallas_kernels as pk
from sppark_tpu.ntt.parameters import get_parameters as jax_parameters
from sppark_tpu_torch.ff import gl64
from sppark_tpu_torch.ntt import kernels as K
from sppark_tpu_torch.util.errors import SpparkError

FIELD = "goldilocks"


@pytest.fixture(autouse=True, scope="module")
def _pallas_interpret():
    # set only while this module's tests run, as test_pallas_interpret.py
    # does: an import-time env change would leak into every other module
    old = os.environ.get("SPPARK_PALLAS_INTERPRET")
    os.environ["SPPARK_PALLAS_INTERPRET"] = "1"
    yield
    if old is None:
        os.environ.pop("SPPARK_PALLAS_INTERPRET", None)
    else:
        os.environ["SPPARK_PALLAS_INTERPRET"] = old


def _words(rng, *shape):
    return gl64.from_wire(rng.integers(0, gl64.P, size=shape,
                                       dtype=np.uint64))


def _jax(t):
    return jnp.asarray(gl64.to_jax_planes(t))


def _port(planes):
    return gl64.from_jax_planes(np.asarray(planes))


# (lg, shape of x without the limb planes, rows_pb, inverse, with_mul,
#  out_t, in_rev, out_rev)
ROWS = [
    (5, (8, 32), 8, False, False, False, True, False),
    (5, (8, 32), 4, True, False, False, False, False),
    (5, (8, 32), 8, False, False, False, True, True),
    (4, (8, 16), 4, False, True, False, True, False),
    (4, (8, 16), 8, True, False, True, True, False),
    (3, (2, 4, 8), 4, False, True, True, True, False),
    (6, (4, 64), 4, True, False, False, False, True),
]


@pytest.mark.parametrize("case", ROWS, ids=lambda c: "-".join(map(str, c)))
def test_rows_plain_vs_pallas(case):
    lg, shape, rows_pb, inverse, with_mul, out_t, in_rev, out_rev = case
    rng = np.random.default_rng(lg * 100 + rows_pb)
    x = _words(rng, *shape)
    mul = _words(rng, *shape) if with_mul else None
    jpm = jax_parameters(FIELD)
    fn = pk._rows_kernel(FIELD, lg, rows_pb, with_mul=with_mul, out_t=out_t,
                         in_rev=in_rev, out_rev=out_rev)
    want = _port(fn(_jax(x), jpm.staged_full_table(lg, inverse),
                    None if mul is None else _jax(mul)))
    tw = _port(jpm.power_table(lg, inverse))
    got = K.ntt_rows_plain(x, tw, lg, mul, in_rev, out_rev, out_t)
    assert torch.equal(got, want)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(K.ntt_rows(x, tw, lg, mul, in_rev, out_rev, out_t),
                       want)


# (lg, shape of x without the limb planes, cols_pb, inverse, with_mul)
COLS = [
    (5, (32, 8), 8, False, False),
    (4, (16, 16), 8, True, True),
    (3, (2, 8, 8), 4, False, True),
]


@pytest.mark.parametrize("case", COLS, ids=lambda c: "-".join(map(str, c)))
def test_cols_plain_vs_pallas(case):
    lg, shape, cols_pb, inverse, with_mul = case
    rng = np.random.default_rng(lg * 100 + cols_pb)
    x = _words(rng, *shape)
    mul = _words(rng, *shape[-2:]) if with_mul else None
    jpm = jax_parameters(FIELD)
    fn = pk._cols_kernel(FIELD, lg, cols_pb, with_mul=with_mul)
    want = _port(fn(_jax(x), jpm.staged_full_table(lg, inverse),
                    None if mul is None else _jax(mul)))
    tw = _port(jpm.power_table(lg, inverse))
    assert torch.equal(K.ntt_cols_plain(x, tw, lg, mul), want)
    assert torch.equal(K.ntt_cols(x, tw, lg, mul), want)


def test_rows_rejects_mul_with_out_rev():
    x = torch.zeros(2, 8, dtype=torch.int64)
    tw = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        K.ntt_rows(x, tw, 3, mul=x, out_rev=True)
    with pytest.raises(ValueError):
        pk._rows_kernel(FIELD, 3, 2, with_mul=True, out_rev=True)


@pytest.mark.parametrize("bad", ["lg", "tw", "dtype", "device"])
def test_wrappers_check_arguments(bad):
    """Shapes, types and devices are checked before any launch; a tensor
    on a device with no kernel (here "meta") raises, never falls back."""
    x = torch.zeros(2, 8, dtype=torch.int64)
    tw = torch.ones(4, dtype=torch.int64)
    lg = 3
    if bad == "lg":
        lg = 4
    elif bad == "tw":
        tw = torch.ones(3, dtype=torch.int64)
    elif bad == "dtype":
        x = x.to(torch.int32)
    else:
        x, tw = x.to("meta"), tw.to("meta")
    err = SpparkError if bad == "device" else (ValueError, TypeError)
    # the device is refused before the kernel's library is built
    match = "no kernel for device" if bad == "device" else None
    with pytest.raises(err, match=match):
        K.ntt_rows(x, tw, lg)
    with pytest.raises(err, match=match):
        K.ntt_cols(x.transpose(0, 1).contiguous(), tw, lg)
    assert K.launches == {"gl64_ntt_rows": 0, "gl64_ntt_cols": 0}
