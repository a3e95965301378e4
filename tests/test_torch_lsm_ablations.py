"""The port's ablations (`hotrap_noretain`, paper Table 3;
`hotrap_nohotcheck`, Table 4) against the numpy reference under every
YCSB mix on hotspot-5%, on the CPU, as `test_torch_lsm.py` holds
`hotrap`: `RunResult.to_json()` equal field for field, every op's
outcome and each level's runs equal."""
import pytest
import torch

from test_torch_lsm import Pair, assert_same_run

SYSTEMS = ["hotrap_noretain", "hotrap_nohotcheck"]
# ops per mix; SR (95% scans) shorter, and shorter still where every
# SD-served scanned record is promoted (hotrap_nohotcheck)
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
    n_ops = 250 if (system, mix) == ("hotrap_nohotcheck", "SR") \
        else OPS[mix]
    w, g = pairs[system].run(mix, "hotspot", n_ops)
    assert_same_run(w, g)
    st = g[0].stats
    if system == "hotrap_noretain" and mix == "UH":
        assert st.promoted_bytes > 0 and st.retained_bytes == 0
    if system == "hotrap_nohotcheck" and mix == "RO":
        assert st.pc_inserts > 0 and st.promoted_bytes > 0
