"""The port's baselines (`rocksdb_fd`, `rocksdb_tiered`) against the
numpy reference under every YCSB mix on hotspot-5%, on the CPU, as
`test_torch_lsm.py` holds `hotrap`: `RunResult.to_json()` equal field
for field, every op's outcome and each level's runs equal.  The
ablations are in `test_torch_lsm_ablations.py`."""
import pytest
import torch

from test_torch_lsm import Pair, assert_same_run

SYSTEMS = ["rocksdb_fd", "rocksdb_tiered"]
# ops per mix; SR (95% scans) shorter
OPS = {"RO": 4000, "RW": 4000, "WH": 4000, "UH": 3000, "SR": 800}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engine's many small CPU ops run fastest on one thread (more
    threads wake a pool for every op)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    return {}


@pytest.mark.parametrize("mix", list(OPS))
@pytest.mark.parametrize("system", SYSTEMS)
def test_system_runs_as_the_reference(pairs, system, mix):
    if system not in pairs:
        pairs[system] = Pair(system)
    w, g = pairs[system].run(mix, "hotspot", OPS[mix])
    assert_same_run(w, g)
    st = g[0].stats
    assert st.promoted_bytes == st.retained_bytes == st.pc_inserts == 0
    if system == "rocksdb_fd":
        assert st.served_sd == 0 and g[0].storage.dev["SD"].busy == 0
