"""The agreement checks that `chip_smoke.py` holds the flash and decode
kernels to on the card, run here against the plain versions at the
script's main shapes (heads and batch cut; the sequence lengths, head
dims and grouping kept, so each output element has the size it has
there).  They accept an independent implementation that rounds
differently, and reject an output that lost one key tile of the flash
kernel or one split of the decode kernel's cache."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as tdecode
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref

BF16, F32 = torch.bfloat16, torch.float32
# the most blocks of 128 threads 132 SMs hold at once (16 an SM): the
# most splits, so the shortest split, any decode plan can give there
MOST_SLOTS = 132 * 16


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def normal(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(BF16)


def attention_f32(q, k, v, keep):
    """Causal GQA attention in float32 over the keys `keep` (Sq, Skv)
    allows, one head at a time. -> (out in q's dtype, lse (B, H, Sq))."""
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    out = torch.empty(B, Sq, H, D, dtype=F32)
    lse = torch.empty(B, H, Sq, dtype=F32)
    for h in range(H):
        s = torch.einsum("bqd,bkd->bqk", q[:, :, h].float(),
                         k[:, :, h // G].float()) * D ** -0.5
        s = s.masked_fill(~keep, float("-inf"))
        lse[:, h] = torch.logsumexp(s, dim=-1)
        out[:, :, h] = torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1),
                                    v[:, :, h // G].float())
    return out.to(q.dtype), lse


# stablelm-3b's training shape (G 1, D 80) and llama3-8b's prefill shape
# (G 4, D 128), 2 and 4 query heads of their 32
FLASH = [(4096, 2, 2, 80), (4096, 4, 1, 128)]


@pytest.mark.parametrize("S,H,KVH,D", FLASH)
@pytest.mark.parametrize("drop", [False, True])
def test_flash_check(S, H, KVH, D, drop):
    """Kept: every key, softmax in float32 (the plain version rounds P to
    bf16).  Dropped: one 128-key tile of the middle, for the last 128
    rows only; both the output check and the lse check must see it."""
    rng = np.random.default_rng(S + D)
    q, k, v = (normal(rng, (1, S, h, D)) for h in (H, KVH, KVH))
    want, want_lse = tflash.flash_attention_plain(q, k, v)
    pos = torch.arange(S)
    keep = pos[None, :] <= pos[:, None]
    if drop:
        keep[S - 128:, S // 2:S // 2 + 128] = False
    got, lse = attention_f32(q, k, v, keep)
    agree = cs.flash_agrees(got, lse, want, want_lse, cs.TOL[BF16])
    if drop:
        assert agree["err_over_tol"] > 1.0
        assert agree["lse_max_abs_err"] > cs.LSE_TOL
        assert not agree["ok"]
    else:
        assert agree["ok"], agree


# the long cache (8 x 30,001 tokens, G 4, D 128; batch cut to 2) and
# stablelm-3b's widths (4 x 3,001 tokens, G 1, D 80; batch cut to 2)
DECODE = [(2, 32, 8, 128, 30_001, 8), (2, 32, 32, 80, 3001, 4)]


@pytest.mark.parametrize("B,H,KVH,D,valid,B_card", DECODE)
@pytest.mark.parametrize("drop", [False, True])
def test_decode_check(B, H, KVH, D, valid, B_card, drop):
    """Kept: the same function in float64.  Dropped: the middle split of
    the plan with the most splits the card could run at this shape
    (`B_card` sequences), from every (sequence, kv head)."""
    rng = np.random.default_rng(valid)
    q = normal(rng, (B, H, D))
    k, v = (normal(rng, (B, valid, KVH, D)) for _ in range(2))
    want = ref.decode_attention_ref(q, k, v, valid)
    if drop:
        split_len, n = tdecode.plan_splits(
            B_card, KVH, valid, tdecode.tile(H // KVH, D, BF16), MOST_SLOTS)
        assert n > 2
        lo = split_len * (n // 2)
        k, v = (torch.cat([x[:, :lo], x[:, lo + split_len:]], dim=1)
                for x in (k, v))
    qg = q.double().reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.double()) * D ** -0.5
    got = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1),
                       v.double()).reshape(B, H, D).to(BF16)
    agree = cs.decode_agrees([got], want, cs.TOL[BF16])
    assert agree["ok"] != drop, agree


def test_placed_check_rejects_a_conv_block_one_channel_off():
    """`chip_smoke.cache_block_err`, the placed checks' cache gate (every
    leaf within 1e-5 of `place` of the one-process cache): it passes each
    rank's own blocks of a mamba2 decode cache on a (1, 2) mesh, and
    rejects a rank whose conv window holds its contiguous block of
    conv_dim one channel off (rank 0's one channel on, rank 1's one
    back)."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import MeshDesc
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = smoke_config("mamba2-1.3b")
    plan = steps.plan_cell(cfg, ShapeSpec("d", "decode", 12, 4),
                           MeshDesc(("data", "model"), (1, 2)))
    g = torch.Generator().manual_seed(4)
    want = [{k: torch.randn(t.shape, generator=g) for k, t in c.items()}
            for c in transformer.init_cache(cfg, 4, 12, "cpu")]
    for rank in range(2):
        mine = steps.place_cache(plan, want, rank=rank)
        err = cs.cache_block_err(plan, mine, want, rank)
        assert set(err) == {"ssm", "conv"} and max(err.values()) == 0.0
        cb = mine[0]["conv"].shape[2]
        start = rank * cb + (1 if rank == 0 else -1)
        off = [dict(c) for c in mine]
        off[0]["conv"] = want[0]["conv"][:, :, start:start + cb].clone()
        assert max(cs.cache_block_err(plan, off, want, rank).values()) > 1e-5


# ----------------------------------------------------------------------
# the lsm phase's comparison of the card's runs against the CPU twin's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def lsm_digest():
    """A tiny HotRAP run's digest: 600 hotspot ops of the RW mix (gets,
    puts), its RunResult and its levels."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # the engine's small ops: one thread
    try:
        db, n_keys, _ = cs.lsm_load("hotrap", "tiny", "cpu")
        runs = [cs.lsm_run(db, "hotrap", "RW", "hotspot", n_keys, 600)
                for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    return tuple(cs.lsm_digest(db, res, outs)
                 for db, res, outs, _, _ in runs)


def test_lsm_check_passes_a_twin(lsm_digest):
    want, got = lsm_digest
    assert len(want["outcomes"]["gets"]) > 300
    assert cs.lsm_mismatches(want, got) == []


def test_lsm_check_rejects_a_one_ulp_float(lsm_digest):
    """One RunResult float one ulp off (the throughput, then a latency
    quantile deep in the tree) is a mismatch."""
    import copy
    want, _ = lsm_digest
    for path in (("throughput",), ("latency", "p99")):
        got = copy.deepcopy(want)
        node = got["result"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = float(np.nextafter(node[path[-1]], np.inf))
        bad = cs.lsm_mismatches(want, got)
        assert len(bad) == 1 and path[-1] in bad[0], bad


def test_lsm_check_rejects_one_differing_get(lsm_digest):
    import copy
    want, _ = lsm_digest
    for col in (0, 1):            # its seq, then its vlen
        got = copy.deepcopy(want)
        got["outcomes"]["gets"][123, col] += 1
        bad = cs.lsm_mismatches(want, got)
        assert bad == [f"outcomes/gets[123]: "
                       f"{want['outcomes']['gets'][123].tolist()} != "
                       f"{got['outcomes']['gets'][123].tolist()}"], bad


def test_lsm_check_rejects_a_differing_run(lsm_digest):
    import copy
    want, _ = lsm_digest
    got = copy.deepcopy(want)
    li = next(i for i, lvl in enumerate(got["levels"]) if lvl)
    got["levels"][li][0][3][7] += 1           # one seq of one table
    assert cs.lsm_mismatches(want, got) == [f"levels[{li}][0] differs"]


# the lsm phase's durable cells: a range cluster with the WAL crashed
# mid-cutover and recovered (`migration_crash_cell`), compared through
# `engine_digest` and `json_mismatches`
@pytest.fixture(scope="module")
def recovered_digests():
    """Two runs of one crash cell on the CPU: (digest, digest)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loaded, n_keys, _ = cs.lsm_load("hotrap", "tiny", "cpu", cs.range2,
                                        wal=True)
        return tuple(cs.migration_crash_cell(loaded, n_keys,
                                             "mid-cutover")[0]
                     for _ in range(2))
    finally:
        torch.set_num_threads(threads)


def test_recovery_check_passes_a_twin(recovered_digests):
    want, got = recovered_digests
    assert want["crashed"]
    assert want["recovered"]["recovery_info"]["topology_discarded"] == 1
    assert cs.json_mismatches(want, got) == []


def test_recovery_check_rejects_a_memtable_one_seq_apart(recovered_digests):
    import copy
    want, _ = recovered_digests
    got = copy.deepcopy(want)
    shard = next(i for i, sh in enumerate(got["recovered"]["shards"])
                 if sh["memtable"])
    key, (seq, vlen) = got["recovered"]["shards"][shard]["memtable"][0]
    got["recovered"]["shards"][shard]["memtable"][0] = (key, (seq + 1, vlen))
    assert cs.json_mismatches(want, got) == [
        f"/recovered/shards[{shard}]/memtable[0][1][0]: {seq} != {seq + 1}"]


def test_recovery_check_rejects_a_bound_off_by_one(recovered_digests):
    import copy
    want, _ = recovered_digests
    for part in ("recovered", "after"):
        got = copy.deepcopy(want)
        node = got[part] if part == "recovered" else got[part]["engine"]
        node["bounds"][0] += 1
        bad = cs.json_mismatches(want, got)
        assert len(bad) == 1 and "/bounds[0]" in bad[0], bad


def test_recovery_check_rejects_a_torn_topology_record(recovered_digests):
    """One topology record torn where the twin's committed."""
    import copy
    want, _ = recovered_digests
    topo = want["recovered"]["topology"]
    assert topo and not any(r["torn"] for r in topo)
    got = copy.deepcopy(want)
    got["recovered"]["topology"][-1]["torn"] = True
    assert cs.json_mismatches(want, got) == [
        f"/recovered/topology[{len(topo) - 1}]/torn: False != True"]


# the lsm phase's plane and sanitizer cells: the hash4 cluster under RW
# with `Observability()` attached (`obs_digest`, `plane_checks`), and the
# range cluster's split and merge under the sanitizer (its close report)
@pytest.fixture(scope="module")
def plane_runs():
    """hash4 RW (5,000 ops) on the CPU, unattached and attached twice:
    (unattached digest, [(attached digest, plane digest, obs)] * 2)."""
    from repro_torch.obs import Observability
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loaded, n_keys, _ = cs.lsm_load("hotrap", "tiny", "cpu", cs.hash4)
        db, res, outs, _, _ = cs.lsm_run(loaded, "hotrap", "RW", "hotspot",
                                         n_keys, 5000)
        base = cs.run_digest(db, res, outs)
        runs = []
        for _ in range(2):
            obs = Observability()
            db, res, outs, _, _ = cs.lsm_run(loaded, "hotrap", "RW",
                                             "hotspot", n_keys, 5000,
                                             obs=obs, name="hash4")
            runs.append((cs.run_digest(db, res, outs), cs.obs_digest(obs),
                         obs))
        return base, runs
    finally:
        torch.set_num_threads(threads)


def test_plane_check_passes_a_twin(plane_runs):
    base, ((d0, p0, obs), (d1, p1, _)) = plane_runs
    assert cs.json_mismatches(p0, p1) == []
    assert cs.plane_checks(base, d0, obs) == {
        "read_only": True, "trace_valid": True, "no_dropped_events": True}
    assert p0["trace"]["traceEvents"] and p0["attribution"]["n_sampled"]


def test_plane_check_rejects_one_event_arg_off_by_one(plane_runs):
    import copy
    _, ((_, want, _), _) = plane_runs
    events = want["trace"]["traceEvents"]
    i = next(j for j, e in enumerate(events)
             if e["ph"] != "M" and any(isinstance(v, int)
                                       and not isinstance(v, bool)
                                       for v in e.get("args", {}).values()))
    name = next(k for k, v in events[i]["args"].items()
                if isinstance(v, int) and not isinstance(v, bool))
    got = copy.deepcopy(want)
    got["trace"]["traceEvents"][i]["args"][name] += 1
    v = events[i]["args"][name]
    assert cs.json_mismatches(want, got) == [
        f"/trace/traceEvents[{i}]/args/{name}: {v} != {v + 1}"]
    got = copy.deepcopy(want)
    got["trace"]["traceEvents"][i]["ts"] = np.nextafter(
        events[i]["ts"], np.inf).item()
    assert len(cs.json_mismatches(want, got)) == 1


def test_plane_check_rejects_a_differing_attached_run(plane_runs):
    """An attached run whose digest differs from the unattached run's
    (one get's seq) fails `read_only`; the attribution it adds does
    not."""
    import copy
    base, ((attached, _, obs), _) = plane_runs
    assert base["result"]["attribution"] is None
    assert attached["result"]["attribution"] is not None
    got = copy.deepcopy(attached)
    got["outcomes"]["gets"][11, 0] += 1
    assert cs.plane_checks(base, got, obs)["read_only"] is False
    got = copy.deepcopy(attached)
    got["engine"]["shards"][0]["seq"] += 1
    assert cs.plane_checks(base, got, obs)["read_only"] is False


def test_plane_check_rejects_a_broken_trace(plane_runs):
    """A trace whose span lost its end, or that dropped an event, fails
    the plane's checks."""
    import copy
    base, ((attached, _, obs), _) = plane_runs
    broken = copy.deepcopy(obs)
    i = next(j for j, e in enumerate(broken.tracer.events) if e["ph"] == "E")
    del broken.tracer.events[i]
    assert cs.plane_checks(base, attached, broken)["trace_valid"] is False
    broken = copy.deepcopy(obs)
    broken.tracer.dropped = 1
    assert cs.plane_checks(base, attached, broken)[
        "no_dropped_events"] is False


@pytest.fixture(scope="module")
def sanitized_digests():
    """The range cluster's sanitized split and merge twice on the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        loaded, n_keys, _ = cs.lsm_load("hotrap", "tiny", "cpu", cs.range2,
                                        wal=True)
        return tuple(cs.split_merge_cell(loaded, n_keys, sanitize=True)[:2]
                     for _ in range(2))
    finally:
        torch.set_num_threads(threads)


def test_sanitizer_check_passes_a_twin(sanitized_digests):
    (want, row), (got, _) = sanitized_digests
    assert cs.json_mismatches(want, got) == []
    assert row["report"]["checks_cutovers_checked"] >= 2
    assert row["splits"] == row["merges"] == 1


def test_sanitizer_check_rejects_one_report_field_off(sanitized_digests):
    import copy
    (want, _), _ = sanitized_digests
    for field in ("checks_refs", "shadow_keys", "last_seq"):
        got = copy.deepcopy(want)
        got["report"][field] += 1
        v = want["report"][field]
        assert cs.json_mismatches(want, got) == [
            f"/report/{field}: {v} != {v + 1}"]


def test_kv_state_check_rejects_a_clock_ulp_and_a_slot():
    """The tiered phase's attached-pass check: one ulp of the clock or
    one moved slot is a mismatch."""
    import copy
    from repro_torch.tiering import KVTierConfig, TieredKVCache
    cfg = KVTierConfig(n_pages=64, fast_slots=8, page_tokens=2, kv_heads=1,
                       head_dim=4, staging_slots=4, sweep_every=16)
    kv = TieredKVCache(cfg, hbm_bw=1e12, pcie_bw=1e10, device="cpu")
    for p in cs.hotspot_stream(64, 300):
        kv.read_pages([p])
    twin = copy.deepcopy(kv)
    assert cs.kv_state_mismatch(kv, twin) == []
    twin.clock.pcie_s = np.nextafter(kv.clock.pcie_s, np.inf)
    assert cs.kv_state_mismatch(kv, twin) == ["clock.pcie_s"]
    twin = copy.deepcopy(kv)
    s = int(np.flatnonzero(twin.page_of_slot >= 0)[0])
    twin.page_of_slot[s] = -1
    assert cs.kv_state_mismatch(kv, twin) == ["page_of_slot"]
