import os
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
# the program under test, as `kvbench/run.py` finds it
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the engine's small CPU ops cost 10-100x more
    with the default pool."""
    import torch
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def small_readback(monkeypatch):
    """A read-back sample a tiny store can hold."""
    monkeypatch.setattr("kvbench.harness.READBACK_SAMPLE", 512)


@pytest.fixture(scope="session")
def roots(tmp_path_factory):
    """The root each test cell is found under: the benchmark itself, or
    for the durable cluster a copy that adds it as data."""
    from kvbench.tests import tiny
    kv4 = tiny.durable_root(tmp_path_factory.mktemp("durable"))
    return {"hotrap-medium.ro-hotspot5": tiny.ROOT,
            "hotrap-medium.rw-hotspot5": tiny.ROOT, tiny.KV4: kv4}
