"""The selection of tests does what pytest.ini says: `xslow` implies `slow`
(the root conftest.py).

Only collection runs in the subprocess, so nothing is compiled."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XSLOW_TEST = "tests/test_msm.py::test_msm_g2_bls12_381"


@pytest.mark.parametrize("expr, selected", [
    ("not slow", False),
    ("xslow", True),
    ("slow", True),
    ("slow and not xslow", False),
])
def test_xslow_selection(expr, selected):
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_msm.py", "--collect-only",
         "-q", "-p", "no:cacheprovider", "-m", expr],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    ids = {line.strip() for line in out.stdout.splitlines()}
    assert (XSLOW_TEST in ids) == selected, out.stdout
