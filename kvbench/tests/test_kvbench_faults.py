"""A whole run, past the harness's look for a card, with the timed path
broken underneath: `correct` comes out false for each fault a cell can
have, in the benchmark's cells and in a durable cluster added as data
(`tiny.KV4`).  (No path here crosses chips, so there is no exchange to
leave out.)"""
import numpy as np
import pytest

from kvbench.tests import tiny

RO = "hotrap-medium.ro-hotspot5"
RW = "hotrap-medium.rw-hotspot5"
KV4 = tiny.KV4


def test_sound_runs_are_correct(roots):
    for cell in (RO, RW, KV4):
        assert tiny.run(cell, seconds=0.3, root=roots[cell])["correct"], cell


@pytest.mark.parametrize("cell", [RO, KV4])
def test_one_get_answer_off_by_one(monkeypatch, roots, cell):
    from repro_torch.core.lsm import TieredLSM
    real = TieredLSM.multi_get
    calls = [0]

    def wrong(self, keys, lat_out=None):
        out = real(self, keys, lat_out)
        calls[0] += 1
        if calls[0] == 20:
            i = next(j for j, r in enumerate(out) if r is not None)
            out[i] = (out[i][0] + 1, out[i][1])
        return out
    monkeypatch.setattr(TieredLSM, "multi_get", wrong)
    res = tiny.run(cell, seconds=0.3, root=roots[cell])
    assert not res["correct"]
    assert res["checks"]["get_mismatches"]["value"] == 1


@pytest.mark.parametrize("cell", [RO, KV4])
def test_half_of_each_batch_left_out(monkeypatch, roots, cell):
    from repro_torch.core.lsm import TieredLSM
    real = TieredLSM.multi_get

    def half(self, keys, lat_out=None):
        h = len(keys) // 2
        return real(self, keys[:h], None) + [None] * (len(keys) - h)
    monkeypatch.setattr(TieredLSM, "multi_get", half)
    res = tiny.run(cell, seconds=0.3, root=roots[cell])
    assert not res["correct"]
    assert res["checks"]["get_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", [RW, KV4])
def test_put_that_leaves_the_state_unchanged(monkeypatch, roots, cell):
    """put_many acknowledges and assigns seqs but applies nothing; reads
    never touch fresh inserts, so the read-back catches it."""
    from repro_torch.core.lsm import TieredLSM
    real = TieredLSM.put_many
    armed = [False]

    def unchanged(self, keys, vlens, seqs=None):
        if not armed[0]:
            return real(self, keys, vlens, seqs)
        n = len(keys)
        sq = (np.arange(self.seq + 1, self.seq + 1 + n) if seqs is None
              else np.asarray(seqs))
        self.seq = int(sq[-1])
        return sq

    real_load = __import__("kvbench.engine", fromlist=["load"]).load

    def load_then_arm(*a, **kw):
        real_load(*a, **kw)
        armed[0] = True
    monkeypatch.setattr(TieredLSM, "put_many", unchanged)
    monkeypatch.setattr("kvbench.engine.load", load_then_arm)
    res = tiny.run(cell, seconds=0.3, root=roots[cell])
    assert not res["correct"]
    assert res["checks"]["readback_mismatches"]["value"] > 0


def test_acknowledged_writes_missing_after_recovery(monkeypatch, roots):
    """Recovery that skips the WAL's replay loses the memtables'
    acknowledged, synced writes.  The memtables are 8 MiB (2 MiB a
    shard), so none flushes after the load and each holds every later
    insert, well over the 63 newest a group commit may lose; at tiny's
    64 KiB a shard they would hold fewer."""
    from repro_torch.core import wal

    def no_replay(self):
        return [], 0
    mt = {"memtable_bytes": 8 << 20}
    assert tiny.run(KV4, seconds=0.3, lsm=mt, root=roots[KV4])["correct"]
    monkeypatch.setattr(wal.WriteAheadLog, "replay", no_replay)
    res = tiny.run(KV4, seconds=0.3, lsm=mt, root=roots[KV4])
    assert not res["correct"]
    assert res["checks"]["readback_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", [RO, RW, KV4])
def test_the_control_fails(roots, cell):
    """The control (`forget_sd`: reads served from the fast device alone)
    in the program's place, at a size a test run holds."""
    from kvbench import control
    res = tiny.run(cell, seconds=0.3, system=control.build,
                   root=roots[cell])
    assert not res["correct"]
    assert res["checks"]["get_mismatches"]["value"] > 0
