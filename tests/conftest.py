import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skipped "
                   "by a fixture where none is present")


def pytest_collection_modifyitems(config, items):
    """Per-test wall-clock ceiling (a hung chaos/fault test must fail, not
    wedge the suite).  Applied only when pytest-timeout is installed (CI
    does, via requirements.txt); without the plugin the suite runs
    unchanged — no warnings, no dependency."""
    if not config.pluginmanager.hasplugin("timeout"):
        return
    for item in items:
        if item.get_closest_marker("timeout") is None:
            item.add_marker(pytest.mark.timeout(300))


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _isolated_runstore(tmp_path, monkeypatch):
    """Point the run store at a per-test tmp dir so executing experiments
    in tests never writes manifests into the repo's runs/store."""
    monkeypatch.setenv("REPRO_RUNSTORE", str(tmp_path / "runstore"))
