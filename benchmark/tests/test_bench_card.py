"""The harness on the card, at the small sizes of small.py: each cell once
traced and once not.  Marked `cuda`; each test skips where no CUDA device
is present.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests
"""

import pytest

from benchmark.tests.small import SMALL, run_small

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_cell_on_the_card(card, name, trace):
    r = run_small(name, trace=trace, device=card)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0 and r["breakdown"]["device_ops"]
