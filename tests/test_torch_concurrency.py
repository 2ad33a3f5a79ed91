"""The port's lock checker (analysis/concurrency.py) and interleaving
fuzzer (analysis/interleave.py), on the CPU.

* Unarmed, `make_lock` gives a plain stdlib lock and `guarded_by` does
  nothing; `PT_FLAGS_concurrency_check` arms it (the flag is read).
* Armed: an A -> B / B -> A pair gives one `lock-order-cycle` naming
  both stacks; a guarded structure touched without its lock gives a
  `guarded-by-violation` (writes-only mode lets reads through); an RLock
  records its outermost level only; a Condition's wait releases the
  tracked lock; the wait / hold histograms reach the metrics registry
  and `profile_snapshot()` carries the "concurrency" section; an armed
  storm over the port's batcher and flight recorder finds nothing.
* `find_failing_seed` over tests/test_concurrency.py's racy counter
  (seeds 0..63) finds the same seed, with the same trace, in both
  packages.

Every thread is joined with a timeout of at most 5 s.
"""
import threading
import time

import pytest

from paddle_tpu_torch.analysis import concurrency as tcc
from paddle_tpu_torch.analysis import interleave as til
from paddle_tpu_torch.analysis.diagnostic import Severity
from paddle_tpu_torch.core import flags as tflags

JOIN_S = 5.0


@pytest.fixture
def armed():
    prev = tflags.get_flag("concurrency_check")
    tflags.set_flag("concurrency_check", True)
    tcc.reset_for_tests()
    try:
        yield
    finally:
        tflags.set_flag("concurrency_check", prev)
        tcc.reset_for_tests()


class _Box:
    pass


def test_unarmed_is_plain_and_the_flag_arms_it(monkeypatch):
    assert tflags._REGISTRY["concurrency_check"].unread is None
    assert not tcc.checking_enabled()
    mu = tcc.make_lock("test.off")
    assert type(mu) is type(threading.Lock())  # lock-ok: type probe
    items = []
    assert tcc.guard_value(items, "x", "test.off") is items
    assert tcc.profile_section() is None
    monkeypatch.setattr(tflags._REGISTRY["concurrency_check"], "value",
                        True)
    assert isinstance(tcc.make_lock("test.on"), tcc.TrackedLock)
    assert isinstance(tcc.make_rlock("test.on.r"), tcc.TrackedRLock)
    assert isinstance(tcc.make_condition("test.on.c")._lock,
                      tcc.TrackedRLock)


def test_lock_order_cycle_names_both_stacks(armed):
    a, b = tcc.make_lock("test.A"), tcc.make_lock("test.B")

    def ab():
        with a:
            with b:
                pass

    def ba():
        with b:
            with a:
                pass

    for fn in (ab, ba):      # one thread after the other: no deadlock
        t = threading.Thread(target=fn)  # thread-ok: joined below
        t.start()
        t.join(timeout=JOIN_S)
        assert not t.is_alive()
    (d,) = tcc.findings()
    assert d.code == "lock-order-cycle" and d.severity == Severity.ERROR
    assert "test.A" in d.message and "test.B" in d.message
    (rec,) = tcc.finding_records()
    assert set(rec["stacks"]) == {"test.A -> test.B", "test.B -> test.A"}
    for direction in rec["stacks"].values():
        assert any("test_torch_concurrency" in fr
                   for fr in direction["then_acquired_at"])
    ab()
    ba()
    assert len(tcc.findings()) == 1          # deduplicated


def test_guarded_by_violations_and_modes(armed):
    mu = tcc.make_lock("test.box")
    box = _Box()
    box.items = []
    tcc.guarded_by(box, "items", "test.box")
    with mu:
        box.items.append(1)
        assert len(box.items) == 1 and box.items == [1]
    assert tcc.findings() == []
    box.items.append(2)
    (d,) = tcc.findings()
    assert d.code == "guarded-by-violation"
    assert "_Box.items" in d.message and "test.box" in d.message
    wmu = tcc.make_lock("test.wbox")
    box.seen = set()
    tcc.guarded_by(box, "seen", "test.wbox", mode="w")
    with wmu:
        box.seen.add("a")
    assert "a" in box.seen                    # lock-free read: allowed
    assert len(tcc.findings()) == 1
    box.seen.add("b")
    assert [f.code for f in tcc.findings()] == ["guarded-by-violation"] * 2


def test_rlock_records_its_outermost_level(armed):
    mu, other = tcc.make_rlock("test.re"), tcc.make_lock("test.other")
    with mu:
        with mu:
            with other:
                pass
    edges = tcc.lock_registry().edges()
    assert list(edges) == ["test.re -> test.other"]
    assert edges["test.re -> test.other"]["count"] == 1
    assert tcc.held_lock_names() == set()


def test_condition_wait_releases_the_tracked_lock(armed):
    cond = tcc.make_condition("test.cond")
    state = {"ready": False, "held_by_producer": None}

    def producer():
        with cond:       # only possible while the waiter has released
            state["held_by_producer"] = tcc.held_lock_names()
            state["ready"] = True
            cond.notify_all()

    t = threading.Thread(target=producer)  # thread-ok: joined below
    with cond:
        t.start()
        assert cond.wait_for(lambda: state["ready"], timeout=JOIN_S)
        assert tcc.held_lock_names() == {"test.cond"}
    t.join(timeout=JOIN_S)
    assert state["held_by_producer"] == {"test.cond"}
    assert tcc.held_lock_names() == set() and tcc.findings() == []


def test_metrics_and_profile_section(armed, tmp_path):
    from paddle_tpu_torch.observability import metrics, profile
    mu = tcc.make_lock("test.prof")
    for _ in range(3):
        with mu:
            pass
    sec = tcc.profile_section()
    assert sec["enabled"] is True
    assert sec["locks"]["test.prof"]["acquisitions"] == 3
    snap = profile.profile_snapshot()
    assert snap["concurrency"]["locks"]["test.prof"]["acquisitions"] == 3
    text = metrics.registry().prometheus_text()
    assert 'pt_lock_wait_seconds_count{lock="test.prof"}' in text
    assert 'pt_lock_hold_seconds_count{lock="test.prof"}' in text
    doc = tcc.write_report(str(tmp_path / "cc.json"))
    assert doc["enabled"] and (tmp_path / "cc.json").exists()


def test_armed_batcher_and_recorder_storms_are_clean(armed):
    from paddle_tpu_torch.observability.recorder import FlightRecorder
    from paddle_tpu_torch.serving.batcher import (DynamicBatcher,
                                                  QueueFullError, Request)
    b = DynamicBatcher(buckets=[1, 2, 4], max_wait=0.0, max_queue=64)
    rec = FlightRecorder(capacity=64)
    stop = threading.Event()
    errors = []

    def producer():
        try:
            while not stop.is_set():
                try:
                    b.put(Request({"x": [[0.0]]},
                                  enqueued_at=time.monotonic()))
                except QueueFullError:
                    time.sleep(0.001)
                rec.record("storm")
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    def consumer():
        try:
            while not stop.is_set():
                batch = b.poll()
                if batch is not None:
                    for r in batch.requests:
                        r.set_result({"y": None})
                rec.snapshot()
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=f)  # thread-ok: joined below
               for f in (producer, producer, consumer)]
    for t in threads:
        t.start()
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join(timeout=JOIN_S)
    b.close(drain=False)
    assert not errors and not any(t.is_alive() for t in threads)
    assert tcc.findings() == [], [d.message for d in tcc.findings()]
    assert tcc.lock_registry().contention()["serving.batcher"][
        "acquisitions"] > 0


def _racy(cc):
    """tests/test_concurrency.py::_racy_scenario over `cc`'s locks: a
    read and a write of an unlocked field, each under the lock."""
    class Counter:
        def __init__(self):
            self.mu = cc.make_lock("test.racy")
            self.value = 0

        def bump(self):
            with self.mu:
                v = self.value
            with self.mu:
                self.value = v + 1

    def make(rounds=4):
        c = Counter()

        def worker():
            for _ in range(rounds):
                c.bump()

        def check():
            assert c.value == 2 * rounds, \
                f"lost update: {c.value} != {2 * rounds}"

        return [("w1", worker), ("w2", worker)], check

    return make


def test_fuzzer_finds_the_jax_packages_seed(armed):
    from paddle_tpu.analysis import concurrency as jcc
    from paddle_tpu.analysis import interleave as jil
    from paddle_tpu.core import flags as jflags
    hit = til.find_failing_seed(_racy(tcc), seeds=range(64))
    assert hit is not None
    seed, result, error = hit
    assert "lost update" in str(error)
    threads, check = _racy(tcc)()
    replay = til.run_interleaved(threads, seed=seed)
    assert replay.trace == result.trace
    with pytest.raises(AssertionError):
        check()
    prev = jflags.get_flag("concurrency_check")
    jflags.set_flag("concurrency_check", True)
    jcc.reset_for_tests()
    try:
        jhit = jil.find_failing_seed(_racy(jcc), seeds=range(64))
    finally:
        jflags.set_flag("concurrency_check", prev)
        jcc.reset_for_tests()
    assert jhit is not None
    assert jhit[0] == seed and jhit[1].trace == result.trace
    assert tcc.findings() == []
