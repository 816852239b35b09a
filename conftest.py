"""Selection of tests for every pytest run under the repo's root.

pytest loads this file before `tests/conftest.py` and `benchmark/tests/`,
so the rule below holds for both packages' tests."""

import pytest


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    """Make every `xslow` test a `slow` test as well.

    pytest keeps only the last `-m` it is given, so a command line's
    `-m 'not slow'` replaces the `-m "not xslow"` of pytest.ini's addopts
    and would select the xslow tests again.  Marking them slow here, before
    pytest's own mark deselection runs, leaves them out of any `-m` that
    leaves out slow, while `-m xslow` still selects them.  So `-m slow`
    selects them too; `-m 'slow and not xslow'` leaves them out."""
    for item in items:
        if item.get_closest_marker("xslow"):
            item.add_marker(pytest.mark.slow)
