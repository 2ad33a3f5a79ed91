"""The port's fault-tolerant training (paddle_tpu_torch/reliability/
{checkpoint,training,watchdog,supervisor}.py), its flag-armed fault
plans, the compile cache's fault sites and utils/debug, against the JAX
package's on the same inputs.

* CheckpointManager: round trip, keep-last-N GC, the corrupt-manifest,
  CRC and truncation skips, a crash mid-write leaving an inert .tmp; a
  restore writes through the tensor a captured graph is bound to;
* checkpoints cross the packages both ways: a JAX-written snapshot
  resumes the port's training and a port-written one the JAX package's,
  and each ends within 1e-5 of max of the other package's parameters;
* `resilient_train_loop` (fc + Momentum, tests/test_reliability.py's
  program): SIGTERM at step 7 checkpoints, the rerun resumes and ends
  bit-equal to the uninterrupted run; a corrupt newest snapshot resumes
  from the one before;
* `Supervisor`: reports equal to the JAX package's under one fake
  `popen` and clock; a real drill on the CPU, `train.step:8:crash`
  armed through the worker's environment, restarts once and ends
  bit-equal;
* `Watchdog`: the FSM's reports equal the JAX package's under one fake
  clock; abort mode exits a wedged subprocess with its diagnosis;
* `compile_cache.read` / `compile_cache.write` faults are clean misses /
  rejects, never a crash or a wrong hit;
* `utils.debug` renders LeNet's program as the JAX package does.

Subprocesses wait under explicit timeouts and are killed in a finally.
"""
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import ir as jir
from paddle_tpu.core import scope as jscope
from paddle_tpu.reliability import CheckpointManager as JCheckpointManager
from paddle_tpu.reliability import resilient_train_loop as jloop
from paddle_tpu.reliability import faults as jfaults
from paddle_tpu.reliability.supervisor import Supervisor as JSupervisor
from paddle_tpu.reliability.supervisor import WorkerSpec as JWorkerSpec
from paddle_tpu.reliability.watchdog import Watchdog as JWatchdog
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.core import compile_cache as cc
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.core.scope import Scope as TScope
from paddle_tpu_torch.reliability import (
    CheckpointManager, FaultError, HungStepError, Supervisor,
    TrainingInterrupted, Watchdog, WorkerSpec, fault_plan,
    resilient_train_loop,
)
from paddle_tpu_torch.reliability import faults as tfaults
from paddle_tpu_torch.static.io import CheckpointError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the training run of tests/test_reliability.py (fc + Momentum on a
#: linear target), shared by this module and the supervised worker, which
#: must not import anything of the JAX package
_PROGRAM_SRC = """
import numpy as np

_RNG = np.random.RandomState(0)
_XS = _RNG.rand(32, 4).astype(np.float32)
_YS = _XS @ np.array([[1.0], [2.0], [3.0], [4.0]], np.float32) + 0.5


def _feed_fn(step):
    i = (step * 8) % 32
    return {"x": _XS[i:i + 8], "y": _YS[i:i + 8]}


def _program(ir, static, optimizer):
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    startup.random_seed = 1
    with ir.program_guard(main, startup):
        x = static.data("x", [-1, 4], "float32", append_batch_size=False)
        y = static.data("y", [-1, 1], "float32", append_batch_size=False)
        loss = static.mean(static.square_error_cost(static.fc(x, 1), y))
        optimizer.Momentum(0.05, 0.9).minimize(loss)
    return main, startup, loss


def _params(main, scope):
    return {v.name: scope.find_np(v.name) for v in main.list_vars()
            if v.persistable and scope.has(v.name)}
"""
exec(_PROGRAM_SRC)


def _ttrain(ckpt_dir, num_steps, interrupt_at=None, save_every=4):
    """One port run (own programs and scope): ("interrupted", step) or
    ("done", (report, params, last loss))."""
    main, startup, loss = _program(tir, tstatic, topt)
    scope, exe = TScope(), TExecutor("cpu")
    exe.run(startup, scope=scope)

    def on_step(step, fetches):
        if interrupt_at is not None and step + 1 == interrupt_at:
            signal.raise_signal(signal.SIGTERM)

    try:
        rep = resilient_train_loop(exe, main, _feed_fn, [loss], num_steps,
                                   ckpt_dir, save_every=save_every,
                                   scope=scope, on_step=on_step)
    except TrainingInterrupted as e:
        return "interrupted", e.step
    last = float(np.asarray(rep["last_fetches"][0]).ravel()[0])
    return "done", (rep, _params(main, scope), last)


def _jtrain(ckpt_dir, num_steps):
    main, startup, loss = _program(jir, pt.static, pt.optimizer)
    sc = jscope.Scope()
    jscope._scope_stack.append(sc)
    try:
        exe = pt.Executor()
        exe.run(startup)
        rep = jloop(exe, main, _feed_fn, [loss], num_steps, ckpt_dir,
                    save_every=4)
        return rep, {v.name: np.asarray(sc.find_np(v.name))
                     for b in main.blocks for v in b.vars.values()
                     if v.persistable and sc.has(v.name)}
    finally:
        jscope._scope_stack.pop()


# ---------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------

def test_checkpoint_roundtrip_gc_and_skips(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(s, tree={"w": np.full((2, 2), s, np.float32),
                          "b": torch.arange(s, dtype=torch.int64)})
    assert mgr.all_steps() == [2, 3]
    tree, step = mgr.restore()
    assert step == 3 and tree["b"].tolist() == [0, 1, 2]
    np.testing.assert_array_equal(tree["w"], np.full((2, 2), 3, np.float32))
    assert mgr.validate(3) == (True, "ok")

    mgr = CheckpointManager(str(tmp_path / "skips"), keep=9)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree={"w": np.ones(8, np.float32) * s})
    with open(tmp_path / "skips" / "ckpt-4" / "MANIFEST.json", "w") as f:
        f.write("{truncated")
    p = tmp_path / "skips" / "ckpt-3" / "params.npz"
    blob = bytearray(p.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    p.write_bytes(blob)
    q = tmp_path / "skips" / "ckpt-2" / "params.npz"
    q.write_bytes(q.read_bytes()[:10])
    assert mgr.validate(4)[1] == "corrupt manifest (not JSON)"
    assert "CRC" in mgr.validate(3)[1]
    assert "truncated" in mgr.validate(2)[1]
    assert mgr.latest_valid() == 1
    assert mgr.restore()[1] == 1
    with pytest.raises(CheckpointError, match="invalid"):
        mgr.restore(3)
    with pytest.raises(CheckpointError, match="no valid checkpoint"):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_crash_mid_write_leaves_an_inert_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree={"w": np.ones(2, np.float32)})
    with fault_plan("checkpoint.write@1:raise"):
        with pytest.raises(FaultError):
            mgr.save(2, tree={"w": np.ones(2, np.float32)})
    assert mgr.all_steps() == [1]
    assert (tmp_path / "ckpt-2.tmp").exists()
    with fault_plan("checkpoint.read:raise"):
        with pytest.raises(FaultError):
            mgr.restore()
    mgr.save(3, tree={"w": np.ones(2, np.float32)})
    assert not (tmp_path / "ckpt-2.tmp").exists()


def test_restore_writes_through_the_bound_tensor(tmp_path):
    """A captured graph holds the scope's bound tensor: the restore must
    land in that very tensor, not beside it."""
    scope = TScope()
    scope.set("w", torch.zeros(3))
    scope.set("v", torch.zeros(2, dtype=torch.float64))
    bound = scope.bind("w", torch.device("cpu"))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree={"w": np.arange(3, dtype=np.float32),
                      "v": np.ones(3, np.float64), "new": np.ones(1)})
    assert mgr.restore_into_scope(scope=scope) == 5
    assert scope.get("w") is bound
    assert bound.tolist() == [0.0, 1.0, 2.0]
    assert scope.get("v").shape == (3,)     # another shape: replaced
    assert scope.find_np("new").tolist() == [1.0]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_resume_across_the_packages(tmp_path, writer):
    """Four steps in one package, the snapshot resumed by the other to
    step 8: the parameters equal the writer's own continuation within
    1e-5 of max."""
    first, second = str(tmp_path / "a"), str(tmp_path / "b")
    if writer == "jax":
        rep, _ = _jtrain(first, 4)
    else:
        status, (rep, _, _) = _ttrain(first, 4)
    assert rep["final_step"] == 4
    shutil.copytree(first, second)
    assert JCheckpointManager(first).latest_valid() == 4
    assert CheckpointManager(first).latest_valid() == 4
    # the writer's own continuation, and the other package's
    if writer == "jax":
        rep_w, want = _jtrain(first, 8)
        status, (rep_o, got, _) = _ttrain(second, 8)
    else:
        status, (rep_w, want, _) = _ttrain(first, 8)
        rep_o, got = _jtrain(second, 8)
    assert rep_w["resumed_from"] == rep_o["resumed_from"] == 4
    assert sorted(got) == sorted(want) and len(want) >= 4
    for name in want:
        w = np.asarray(want[name], np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(np.asarray(got[name], np.float64) - w).max())
        assert err <= 1e-5 * scale, (name, err, scale)


# ---------------------------------------------------------------------
# resilient_train_loop
# ---------------------------------------------------------------------

def test_sigterm_kill_and_resume_is_bit_equal(tmp_path):
    status, (rep_a, params_a, loss_a) = _ttrain(str(tmp_path / "a"), 12)
    assert status == "done" and rep_a["resumed_from"] == 0
    status, step = _ttrain(str(tmp_path / "b"), 12, interrupt_at=7)
    assert status == "interrupted" and step == 7
    mgr = CheckpointManager(str(tmp_path / "b"))
    assert mgr.latest_valid() == 7
    assert mgr.metadata(7).get("interrupted") is True
    status, (rep_b, params_b, loss_b) = _ttrain(str(tmp_path / "b"), 12)
    assert status == "done" and rep_b["resumed_from"] == 7
    assert sorted(params_a) == sorted(params_b)
    for name in params_a:
        np.testing.assert_array_equal(params_a[name], params_b[name],
                                      err_msg=name)
    assert loss_a == loss_b


def test_resume_skips_a_corrupt_snapshot(tmp_path):
    _, (_, params_a, _) = _ttrain(str(tmp_path / "a"), 12)
    d = str(tmp_path / "b")
    assert _ttrain(d, 12, interrupt_at=8) == ("interrupted", 8)
    with open(os.path.join(d, "ckpt-8", "MANIFEST.json"), "w") as f:
        f.write("not json")
    assert CheckpointManager(d).latest_valid() == 4
    status, (rep, params_b, _) = _ttrain(d, 12)
    assert rep["resumed_from"] == 4
    for name in params_a:
        np.testing.assert_array_equal(params_a[name], params_b[name])


def test_train_step_site_and_numerics(tmp_path):
    from paddle_tpu_torch.observability import metrics
    with fault_plan("train.step:2:raise(planted)"):
        with pytest.raises(FaultError, match="planted"):
            _ttrain(str(tmp_path / "a"), 4, save_every=0)
    reg = metrics.registry()
    nonfinite = reg.counter("pt_train_nonfinite_total")
    before = nonfinite.labels().value
    from paddle_tpu_torch.reliability.training import _NumericsMonitor
    mon = _NumericsMonitor()
    norm, bad = mon.observe(3, [np.array([3.0, np.nan, 4.0], np.float32),
                                torch.tensor([1], dtype=torch.int64)])
    assert norm == 5.0 and bad and mon.first_bad_step == 3
    assert nonfinite.labels().value == before + 1


# ---------------------------------------------------------------------
# Supervisor
# ---------------------------------------------------------------------

class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _FakeProc:
    """Exits with `code` after `polls` polls; a SIGTERM ends it with 143
    unless it ignores signals."""

    def __init__(self, code, polls, clock, stubborn=False):
        self.code, self.polls, self.clock = code, polls, clock
        self.stubborn = stubborn
        self.returncode = None
        self.pid = 4242

    def poll(self):
        self.clock.t += 1.0
        if self.returncode is None and self.polls <= 0:
            self.returncode = self.code
        self.polls -= 1
        return self.returncode

    def send_signal(self, sig):
        if not self.stubborn:
            self.returncode = 143

    def wait(self, timeout=None):
        if self.returncode is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.returncode

    def kill(self):
        self.returncode = -9


def _supervise(Sup, Spec, plan, tmp, **kw):
    clock = FakeClock()
    scripts = {r: list(s) for r, s in plan.items()}
    launches = []

    def popen(cmd, env=None, **_):
        rank = int(cmd[-1])
        code, polls, stubborn = scripts[rank].pop(0)
        launches.append((rank, env["PT_ELASTIC_RESTARTS"],
                         os.path.basename(env["PT_FLIGHT_DUMP"])))
        return _FakeProc(code, polls, clock, stubborn)

    specs = [Spec(r, ["worker", str(r)], env={"RANK": str(r)})
             for r in sorted(plan)]
    sup = Sup(specs, clock=clock, popen=popen, restart_delay=0.0,
              drain_timeout=0.0, handle_signals=False,
              flight_dir=str(tmp), **kw)
    return sup.run(poll=0.0), launches


@pytest.mark.parametrize("plan,kw", [
    ({0: [(3, 1, False), (0, 2, False)], 1: [(0, 0, False)]},
     dict(max_restarts=3, restart_window=60.0)),
    ({0: [(5, 0, False)] * 3, 1: [(0, 99, False)]},
     dict(max_restarts=2, restart_window=60.0)),
    ({0: [(7, 0, False)] * 4, 1: [(0, 99, True)]},
     dict(max_restarts=1, restart_window=2.5)),
])
def test_supervisor_reports_equal_the_references(tmp_path, plan, kw):
    want = _supervise(JSupervisor, JWorkerSpec, plan, tmp_path, **kw)
    got = _supervise(Supervisor, WorkerSpec, plan, tmp_path, **kw)
    assert got == want
    report = got[0]
    assert report["workers"]["0"]["restarts"] == len(plan[0]) - 1 or \
        not report["success"]


_WORKER = _PROGRAM_SRC + textwrap.dedent("""
    import json, sys
    sys.path.insert(0, sys.argv[3])
    from paddle_tpu_torch import optimizer, static
    from paddle_tpu_torch.core import ir
    from paddle_tpu_torch.core.executor import Executor
    from paddle_tpu_torch.core.scope import Scope
    from paddle_tpu_torch.reliability import resilient_train_loop
    main, startup, loss = _program(ir, static, optimizer)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    rep = resilient_train_loop(exe, main, _feed_fn, [loss], 12,
                               sys.argv[1], save_every=4, scope=scope)
    np.savez(sys.argv[2], **_params(main, scope))
    print("WORKER " + json.dumps({"resumed_from": rep["resumed_from"],
                                  "jax": "jax" in sys.modules}))
""")



def test_supervised_restart_drill_on_the_cpu(tmp_path):
    """`train.step:8:crash` through the worker's environment: the first
    incarnation dies right after the step-8 snapshot, the supervisor
    restarts it once, it resumes at 8 and ends bit-equal to the
    uninterrupted run."""
    _, (_, want, _) = _ttrain(str(tmp_path / "plain"), 12)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = str(tmp_path / "final.npz")
    log = str(tmp_path / "worker.log")
    env = {"PT_FLAGS_fault_plan": "train.step:8:crash",
           "JAX_PLATFORMS": "cpu"}
    procs = []

    def popen(cmd, **kw):
        p = subprocess.Popen(cmd, **kw)
        procs.append(p)
        return p

    sup = Supervisor([WorkerSpec(0, [sys.executable, str(script),
                                     str(tmp_path / "ckpt"), out, REPO],
                                 env=env, log_path=log)],
                     max_restarts=2, restart_delay=0.0, popen=popen,
                     flight_dir=str(tmp_path / "flight"),
                     handle_signals=False)
    try:
        report = sup.run(poll=0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    w = report["workers"]["0"]
    assert report["success"] and w["exit_codes"] == [17, 0], (
        report, open(log).read()[-2000:])
    assert w["restarts"] == 1 and len(w["flight_dumps"]) == 2
    lines = [json.loads(ln[len("WORKER "):]) for ln in open(log)
             if ln.startswith("WORKER ")]
    assert lines == [{"resumed_from": 8, "jax": False}]
    with np.load(out) as z:
        assert sorted(z.files) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)


# ---------------------------------------------------------------------
# Watchdog
# ---------------------------------------------------------------------

def _watchdog_trace(Wd, tmp_path):
    ck = FakeClock()
    seen = []
    wd = Wd(deadline=2.0, mode="callback", on_stall=seen.append, clock=ck,
            stream=io.StringIO())
    out = []
    for i, dur in enumerate([1.0, 1.0, 1.0, 1.0, 9.0]):
        with wd.watch(f"s{i}"):
            ck.t += dur
        out.append(wd.check())
    out.append(wd.step_stats())
    wd.arm("hang")
    for dt in (1.5, 0.4, 0.2, 5.0):
        ck.t += dt
        rep = wd.check()
        out.append(None if rep is None else (rep.tag, rep.silent_for,
                                             rep.deadline))
        if dt == 0.4:
            wd.beat("progress")
    out.append([(r.tag, r.silent_for) for r in seen])
    return out


def test_watchdog_fsm_equals_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("PT_FLIGHT_DIR", str(tmp_path))
    want = _watchdog_trace(JWatchdog, tmp_path)
    got = _watchdog_trace(Watchdog, tmp_path)
    assert got == want
    assert got[5]["stragglers"] == [4]
    ck = FakeClock()
    buf = io.StringIO()
    wd = Watchdog(deadline=1.0, mode="event", clock=ck, stream=buf)
    wd.arm("t")
    ck.t = 2.0
    rep = wd.check()
    assert rep is not None and wd.check() is None
    with pytest.raises(HungStepError):
        wd.raise_if_stalled()
    assert "WATCHDOG" in buf.getvalue()
    assert rep.flight_dump and os.path.exists(rep.flight_dump)


def test_watchdog_abort_kills_a_wedged_process():
    src = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        from paddle_tpu_torch.reliability.watchdog import Watchdog
        wd = Watchdog(deadline=0.2, interval=0.05, mode="abort",
                      abort_code=87).start()
        wd.arm("wedged-step")
        time.sleep(30)
    """)
    p = subprocess.Popen([sys.executable, "-c", src], text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)
    assert p.returncode == 87, (p.returncode, err)
    assert "WATCHDOG" in err and "wedged-step" in err
    assert "profiler counters" in err or "flight recorder" in err


# ---------------------------------------------------------------------
# fault plans from the flag; the compile cache's fault sites
# ---------------------------------------------------------------------

def test_flag_arms_the_plan_and_sites_match_the_reference():
    assert set(tfaults.KNOWN_SITES) == set(jfaults.KNOWN_SITES)
    prev = flags.get_flag("fault_plan")
    try:
        flags.set_flag("fault_plan", "probe.site@2:raise")
        tfaults.reset_to_flags()
        plan = tfaults.get_fault_plan()
        assert plan is not None and plan.spec == "probe.site@2:raise"
        tfaults.inject_point("probe.site")
        with pytest.raises(FaultError):
            tfaults.inject_point("probe.site")
    finally:
        flags.set_flag("fault_plan", prev)
        tfaults.reset_to_flags()
    assert tfaults.get_fault_plan() is None


def test_flag_arms_a_child_process():
    src = ("import sys; sys.path.insert(0, %r)\n"
           "from paddle_tpu_torch.reliability import faults\n"
           "faults.inject_point('train.step', tag='3')\n" % REPO)
    p = subprocess.run([sys.executable, "-c", src], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ,
                                PT_FLAGS_fault_plan="train.step:3:crash(9)"))
    assert p.returncode == 9 and "injected crash(9)" in p.stderr


@pytest.fixture
def cache(tmp_path):
    from paddle_tpu_torch.observability import profile as prof
    flags.set_flag("compile_cache_dir", str(tmp_path / "cache"))
    cc.reset_compile_cache()
    prof.reset_profile()
    yield cc.compile_cache()
    flags.set_flag("compile_cache_dir", "")
    cc.reset_compile_cache()
    prof.reset_profile()


SIG = (("tokens", (2, 8), "int32"),)


def test_compile_cache_faults_are_clean_misses_and_rejects(cache):
    kh = cache.key_for("tok", ((s, d) for _, s, d in SIG), ())
    with fault_plan("compile_cache.write:raise"):
        assert cache.store(kh, "tok", SIG, (), 1, 0.1) == (
            "reject", "io_error:FaultError")
    assert os.listdir(cache.entries_dir) == []     # nothing half written
    assert cache.lookup(kh) == (None, 0.0, "absent")
    assert cache.store(kh, "tok", SIG, (), 1, 0.1) == ("store", None)
    cache.write_manifest("m", entries=[{"key_hash": kh,
                                        "component": "generation",
                                        "key": "rung"}])
    cc.reset_compile_cache()
    fresh = cc.compile_cache()
    with fault_plan("compile_cache.read:raise"):
        assert fresh.lookup(kh) == (None, 0.0, "io_error:FaultError")

        class Wrapper:
            cache_token = "tok"
            warmed = []

            def warm(self, meta, load_s=0.0):
                self.warmed.append(meta)
                return True

        w = Wrapper()
        report = fresh.warm_start("m", [w])
        assert report["loaded"] == 0 and w.warmed == []
    meta, _, where = fresh.lookup(kh)               # the fault gone: a hit
    assert where == "disk" and meta["key_hash"] == kh
    events = [(e["event"], e.get("reason", "")) for e in fresh.events()]
    assert ("miss", "io_error:FaultError") in events


# ---------------------------------------------------------------------
# utils.debug
# ---------------------------------------------------------------------

def _lenet(ir, static, lenet, optimizer):
    ir.reset_unique_names()
    main, startup = ir.Program(), ir.Program()
    with ir.program_guard(main, startup):
        img = static.data("img", [1, 28, 28])
        label = static.data("label", [1], "int64")
        _, loss, _ = lenet.build_static(img, label)
        optimizer.SGD(0.1).minimize(loss)
    return main


def test_debug_strings_equal_the_references(tmp_path):
    from paddle_tpu.models import lenet as jlenet
    from paddle_tpu.utils import debug as jdebug
    from paddle_tpu_torch.models import lenet as tlenet
    from paddle_tpu_torch.utils import debug as tdebug
    jm = _lenet(jir, pt.static, jlenet, pt.optimizer)
    tm = _lenet(tir, tstatic, tlenet, topt)
    for kw in ({}, {"with_shapes": False}, {"with_diagnostics": True}):
        want = jdebug.program_debug_string(jm, **kw)
        assert tdebug.program_debug_string(tm, **kw) == want, kw
    assert tdebug.program_to_dot(tm) == jdebug.program_to_dot(jm)
    path = tdebug.save_program_dot(tm, str(tmp_path / "g.dot"))
    assert open(path).read().startswith("digraph program {")
