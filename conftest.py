"""Pytest set-up for the whole repo that xdist's controller process must see.

``--dist loadfile`` (pytest.ini and the repo's test commands) hands each
file to one worker as a single unit of work. Here its unit is narrowed to
a test's class where it has one, else its file: xdist's own
``LoadScopeScheduling``. A unit still runs whole on one worker, so a port
file (``tests/test_torch_*.py``: module-level tests sharing module
fixtures) builds each fixture once, while the long classes of one JAX
package file (``tests/test_parallel.py``) run on several workers instead
of one after another. No JAX test file scopes a fixture wider than a
function, so no fixture is built twice. The unit follows from the node id
alone; other ``--dist`` modes and ``-n 0`` are grouped as xdist groups
them.
"""

import pytest


@pytest.hookimpl(optionalhook=True, tryfirst=True)
def pytest_xdist_make_scheduler(config, log):
    # tryfirst: xdist's own implementation answers for every mode it knows.
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadScopeScheduling  # xdist is optional

    return LoadScopeScheduling(config, log)
