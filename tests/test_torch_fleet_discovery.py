"""The port's fleet directory, hash ring and snapshot store against the
JAX package's (paddle_tpu_torch/fleet/{discovery,router}.py vs
paddle_tpu/fleet/).

* the same scripted announces, beats, failures, evictions and sweeps at
  the same fake-clock times give equal directory snapshots (states,
  generations, tombstones) and equal event logs after every step;
* `HashRing.lookup` is equal on 1000 keys through joins and departures
  (blake2b, 64 points: a session lands on the same backend name in both
  packages);
* a `DirectoryStore` snapshot written by either package loads in the
  other, and a directory adopts the other package's snapshot with the
  same generations;
* a corrupt newest snapshot and `fleet.snapshot_write` /
  `fleet.snapshot_read` / `fleet.adopt` faults fall back as the JAX
  package's do.
"""
import json
import os

import pytest

from paddle_tpu import fleet as jfleet
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.reliability import faults as tfaults


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


#: (time, op, args): every edge of the liveness FSM — announce, beats
#: with load docs, silence to SUSPECT, a recovering beat, forward
#: failures forcing SUSPECT, silence to LOST, a zombie beat, a rejoin as
#: a fresh generation, an explicit eviction, a poller observation
SCRIPT = [
    (100.0, "announce", ("b0", ("127.0.0.1", 4000), {"pid": 1})),
    (100.0, "announce", ("b1", ("127.0.0.1", 4001), {"pid": 2})),
    (100.5, "beat", ("b0", {"queue_depth": 3})),
    (101.0, "beat", ("b1", None)),
    (101.5, "sweep", ()),
    (102.6, "sweep", ()),               # b0 silent 2.1 s: SUSPECT
    (102.7, "beat", ("b0", {"queue_depth": 1})),   # recovers
    (102.8, "observe", ("b1", "degraded", {"queue_depth": 9})),
    (103.0, "failure", ("b1",)),
    (103.1, "failure", ("b1",)),        # 2 in a row: SUSPECT
    (103.2, "announce", ("b2", ("127.0.0.1", 4002), None)),
    (105.0, "beat", ("b0", None)),
    (105.0, "beat", ("b2", None)),
    (107.2, "sweep", ()),               # b1 silent 6.2 s: LOST
    (107.3, "beat", ("b1", None)),      # the zombie is refused
    (107.4, "announce", ("b1", ("127.0.0.1", 4011), {"pid": 3})),
    (108.0, "evict", ("b2", "retired")),
    (111.5, "sweep", ()),
    (118.0, "sweep", ()),
]


def _run(fleet, clock, directory, op, args):
    if op == "announce":
        return directory.announce(*args)
    if op == "beat":
        return directory.beat(*args)
    if op == "sweep":
        return directory.sweep()
    if op == "observe":
        return directory.observe(args[0], verdict=args[1], load=args[2])
    if op == "failure":
        return directory.report_failure(*args)
    if op == "evict":
        return directory.evict(args[0], reason=args[1])
    raise ValueError(op)


def _trace(fleet):
    clock = FakeClock()
    d = fleet.FleetDirectory(suspect_after_s=2.0, lost_after_s=6.0,
                             clock=clock)
    evicted, joined = [], []
    d.on_evict(lambda snap: evicted.append(snap["name"]))
    d.on_join(lambda snap: joined.append(snap["name"]))
    out = []
    for t, op, args in SCRIPT:
        clock.t = t
        ret = _run(fleet, clock, d, op, args)
        out.append((op, ret, d.snapshot(), d.selectable(), d.names()))
    return out, evicted, joined


def test_directory_fsm_equals_the_references():
    want, want_ev, want_join = _trace(jfleet)
    got, got_ev, got_join = _trace(tfleet)
    assert got_ev == want_ev and got_join == want_join
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, SCRIPT[i])
    states = [{n: r["state"] for n, r in snap["backends"].items()}
              for _, _, snap, _, _ in got]
    # the script walks every edge
    seen = {s for st in states for s in st.values()}
    assert seen == {"LIVE", "SUSPECT"}
    assert got[-1][2]["tombstones"]["b2"]["evict_reason"] == "retired"
    assert got[14][1] is False                  # the zombie beat
    assert got[15][2]["backends"]["b1"]["generation"] == 4


def test_hash_ring_equals_the_references_through_membership_changes():
    keys = [f"session-{i}" for i in range(1000)]
    jr, tr = jfleet.HashRing(), tfleet.HashRing()
    steps = [["b0", "b1"], ["b0", "b1", "b2"], ["b0", "b1", "b2", "b3"],
             ["b0", "b2", "b3"], ["b3"], []]
    prev = None
    for names in steps:
        jr.rebuild(names)
        tr.rebuild(names)
        got = [tr.lookup(k) for k in keys]
        assert got == [jr.lookup(k) for k in keys]
        allowed = set(names[:1])
        assert [tr.lookup(k, allowed=allowed) for k in keys[:100]] == \
            [jr.lookup(k, allowed=allowed) for k in keys[:100]]
        if prev is not None and names and len(names) < len(prev[0]):
            # a departure moves only the departed member's keys
            gone = set(prev[0]) - set(names)
            for k, before, after in zip(keys, prev[1], got):
                if before not in gone:
                    assert after == before
        prev = (names, got)
    assert tr.lookup("x") is None


def _doc(fleet):
    clock = FakeClock()
    d = fleet.FleetDirectory(suspect_after_s=2.0, lost_after_s=6.0,
                             clock=clock)
    d.extra_state("router", lambda: {"epoch": 3, "name": "r"})
    d.announce("b0", ("127.0.0.1", 4000), {"pid": 1},
               load={"queue_depth": 2})
    d.announce("b1", ("127.0.0.1", 4001), {"pid": 2})
    return d


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_load_in_the_other_package(tmp_path, writer):
    src, dst = (jfleet, tfleet) if writer == "jax" else (tfleet, jfleet)
    d = _doc(src)
    d.attach_store(src.DirectoryStore(str(tmp_path)))
    seq = d.save_snapshot()
    doc, got_seq = dst.DirectoryStore(str(tmp_path)).load_latest()
    assert got_seq == seq
    want, _ = src.DirectoryStore(str(tmp_path)).load_latest()
    assert doc == want and doc["format"] == "fleet-snapshot-v1"
    assert doc["extras"]["router"]["epoch"] == 3
    # the other package's directory adopts it with the same generations
    clock = FakeClock(500.0)
    other = dst.FleetDirectory(suspect_after_s=2.0, lost_after_s=6.0,
                               clock=clock)
    adopted, extras = other.adopt(doc)
    assert sorted(adopted) == ["b0", "b1"] and extras == doc["extras"]
    assert other.get("b0")["generation"] == d.get("b0")["generation"]
    assert other.get("b0")["load"] == {"queue_depth": 2}
    assert other.get("b1")["last_beat"] == 500.0


def _store_faults(fleet, faults, root):
    store = fleet.DirectoryStore(root, keep=3)
    seqs = [store.save({"n": i}) for i in range(4)]
    names = sorted(os.listdir(root))
    out = {"seqs": seqs, "names": names}
    # a corrupt newest snapshot: the walk falls back
    with open(os.path.join(root, "fleet-%06d" % seqs[-1], "fleet.json"),
              "w") as f:
        f.write('{"n": 99}')
    out["corrupt"] = store.load_latest()
    # a write fault publishes nothing
    with faults.fault_plan("fleet.snapshot_write:raise"):
        with pytest.raises(faults.FaultError):
            store.save({"n": 5})
    out["after_write_fault"] = (store.load_latest(),
                                sorted(os.listdir(root)))
    # a read fault on the newest valid one: the next older serves
    with faults.fault_plan(f"fleet.snapshot_read:{seqs[-2]}:raise"):
        out["read_fault"] = store.load_latest()
    # adoption: a fault on one backend skips it, the rest adopt
    clock = FakeClock()
    d = fleet.FleetDirectory(suspect_after_s=2.0, lost_after_s=6.0,
                             clock=clock)
    doc = {"generation_counter": 7, "backends": [
        {"name": n, "address": ["127.0.0.1", 4000 + i], "generation": i}
        for i, n in enumerate(("b0", "b1", "b2"))]}
    with faults.fault_plan("fleet.adopt:b1:raise"):
        out["adopt"] = d.adopt(doc)
    out["events"] = d.snapshot()["events"]
    return out


def test_corrupt_newest_and_faults_fall_back_as_the_references(tmp_path):
    want = _store_faults(jfleet, jfaults, str(tmp_path / "jax"))
    got = _store_faults(tfleet, tfaults, str(tmp_path / "port"))
    assert got == want
    assert got["corrupt"] == ({"n": 2}, 3)
    assert got["read_fault"] == ({"n": 1}, 2)
    assert got["adopt"][0] == ["b0", "b2"]


def test_save_snapshot_survives_a_broken_provider_and_store(tmp_path):
    d = _doc(tfleet)
    d.attach_store(tfleet.DirectoryStore(str(tmp_path)))
    d.extra_state("bad", lambda: 1 / 0)
    assert d.save_snapshot() is not None
    assert d.snapshot_errors == 1
    with tfaults.fault_plan("fleet.snapshot_write:raise"):
        assert d.save_snapshot() is None
    assert d.snapshot_errors == 3        # the provider again, the write
    doc, _ = d.store.load_latest()
    assert json.dumps(doc, sort_keys=True)
