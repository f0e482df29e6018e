"""The xdist work unit that the repo's root conftest.py chooses."""

from pathlib import Path
from types import SimpleNamespace

import pytest
from xdist.scheduler import LoadScopeScheduling

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"


@pytest.mark.parametrize(
    "dist", ["loadfile", "load", "loadscope", "loadgroup", "worksteal", "each"])
def test_hook_groups_by_class_only_under_loadfile(pytestconfig, dist):
    # Looked up among the registered plugins: this also shows the file is
    # loaded as a conftest of a run of tests/.
    root = pytestconfig.pluginmanager.get_plugin(str(ROOT_CONFTEST))
    assert root is not None
    config = SimpleNamespace(getvalue={"dist": dist, "tx": ["popen"]}.get)
    sched = root.pytest_xdist_make_scheduler(config, log=None)
    if dist == "loadfile":
        assert type(sched) is LoadScopeScheduling
    else:
        assert sched is None
