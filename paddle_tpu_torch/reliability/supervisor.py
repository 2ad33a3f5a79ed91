"""Elastic worker supervision: restart-with-resume for crashed trainers.

Counterpart of paddle_tpu/reliability/supervisor.py, the supervision
loop behind `python -m paddle_tpu_torch.distributed.launch --elastic`
(or drive `Supervisor` directly through `WorkerSpec`s):

* a crashed worker is relaunched with the SAME rank and environment plus
  `PT_ELASTIC_RESTARTS=<n>`, up to `max_restarts` restarts within a
  `restart_window`-second sliding window — a crash loop exhausts its
  budget and fails the job instead of flapping forever;
* restarted workers auto-resume: scripts built on
  `reliability.training.resilient_train_loop` pick up at the recorded
  step, so a kill-at-step-k supervised run matches the uninterrupted one;
* SIGTERM/SIGINT to the supervisor drains gracefully: workers get
  SIGTERM (resilient_train_loop snapshots and exits), stragglers are
  SIGKILLed at the drain deadline and reported as undrained;
* each incarnation gets its own flight-dump path (PT_FLIGHT_DUMP under
  `flight_dir`), named in the report;
* the final supervision report (per-rank restarts, exit codes, drained
  flags, flight dumps) is emitted as JSON.

Injectable `clock` / `popen` keep the restart-budget FSM testable
without real processes.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

from paddle_tpu_torch.core.enforce import enforce

__all__ = ["WorkerSpec", "Supervisor"]


class WorkerSpec:
    """One supervised worker: its rank, argv, env overlay, and log."""

    def __init__(self, rank, cmd, env=None, log_path=None):
        self.rank = int(rank)
        self.cmd = list(cmd)
        self.env = dict(env or {})
        self.log_path = log_path


class _WorkerState:
    __slots__ = ("spec", "proc", "restart_times", "exit_codes", "done",
                 "failed", "drained", "log_fd", "flight_dumps")

    def __init__(self, spec):
        self.spec = spec
        self.proc = None
        self.restart_times = []   # launch times of RESTARTS (not the first)
        self.exit_codes = []
        self.done = False
        self.failed = False
        self.drained = None       # set during a drain: True/False
        self.log_fd = None
        self.flight_dumps = []    # one assigned dump path per incarnation


class Supervisor:
    """Run workers to completion, restarting crashes within budget.

    `run()` returns the JSON-serializable supervision report; the
    process exit code convention is `report["exit_code"]` (0 = every
    worker finished cleanly)."""

    def __init__(self, specs, max_restarts=3, restart_window=60.0,
                 restart_delay=0.2, drain_timeout=10.0, report_path=None,
                 clock=time.monotonic, popen=subprocess.Popen,
                 handle_signals=True, flight_dir=None):
        enforce(specs, "Supervisor needs at least one WorkerSpec")
        enforce(max_restarts >= 0, "max_restarts must be >= 0")
        self.specs = list(specs)
        self.max_restarts = int(max_restarts)
        self.restart_window = float(restart_window)
        self.restart_delay = float(restart_delay)
        self.drain_timeout = float(drain_timeout)
        self.report_path = report_path
        self.clock = clock
        self.popen = popen
        self.handle_signals = handle_signals
        # flight-recorder dumps: every worker incarnation gets its own
        # dump path (PT_FLIGHT_DUMP) under this directory, so the
        # watchdog-abort / SIGTERM dump of each crash survives the
        # restart and is named in the supervision report per restart
        self.flight_dir = (flight_dir
                           or os.environ.get("PT_FLIGHT_DIR") or None)
        self._stop = threading.Event()
        self._workers = [_WorkerState(s) for s in self.specs]

    # -- lifecycle ------------------------------------------------------
    def _launch(self, st):
        spec = st.spec
        env = dict(os.environ)
        env.update(spec.env)
        env["PT_ELASTIC"] = "1"
        env["PT_ELASTIC_RESTARTS"] = str(len(st.restart_times))
        if self.flight_dir:
            os.makedirs(self.flight_dir, exist_ok=True)
            dump = os.path.join(
                self.flight_dir,
                f"flight-rank{spec.rank}"
                f"-attempt{len(st.restart_times)}.json")
            env["PT_FLIGHT_DUMP"] = dump
            st.flight_dumps.append(dump)
        kwargs = {"env": env}
        if spec.log_path:
            if st.log_fd is None:
                os.makedirs(os.path.dirname(spec.log_path) or ".",
                            exist_ok=True)
                # append across incarnations: one log tells the whole
                # crash/restart/resume story for the rank
                st.log_fd = open(spec.log_path, "a")
            kwargs["stdout"] = st.log_fd
            kwargs["stderr"] = subprocess.STDOUT
        st.proc = self.popen(spec.cmd, **kwargs)

    def _restart_allowed(self, st):
        now = self.clock()
        st.restart_times = [t for t in st.restart_times
                            if now - t <= self.restart_window]
        return len(st.restart_times) < self.max_restarts

    def request_stop(self):
        """Graceful drain from any thread (the SIGTERM handler)."""
        self._stop.set()

    def _drain(self):
        # only workers still running get SIGTERMed (and their exit code
        # recorded here); workers that already exited had their code
        # recorded by the monitor loop
        to_wait = []
        for st in self._workers:
            if st.proc is not None and st.proc.poll() is None:
                try:
                    st.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
                to_wait.append(st)
            else:
                st.drained = True
        deadline = time.monotonic() + self.drain_timeout
        for st in to_wait:
            try:
                st.proc.wait(timeout=max(0.1,
                                         deadline - time.monotonic()))
                st.drained = True
            except subprocess.TimeoutExpired:
                st.drained = False
                st.proc.kill()
                st.proc.wait()
            st.exit_codes.append(st.proc.returncode)

    def run(self, poll=0.05):
        prev_handlers = {}
        install = (self.handle_signals and threading.current_thread()
                   is threading.main_thread())
        if install:
            def _on_sig(signum, frame):
                self.request_stop()
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, _on_sig)

        interrupted = False
        exit_code = 0
        try:
            for st in self._workers:
                self._launch(st)
            while True:
                if self._stop.is_set():
                    interrupted = True
                    self._drain()
                    break
                n_running = 0
                crashed = None
                for st in self._workers:
                    if st.done or st.failed:
                        continue
                    ret = st.proc.poll()
                    if ret is None:
                        n_running += 1
                        continue
                    st.exit_codes.append(ret)
                    if ret == 0:
                        st.done = True
                        continue
                    if self._restart_allowed(st):
                        sys.stderr.write(
                            f"[supervisor] worker {st.spec.rank} exited "
                            f"with code {ret}; restarting "
                            f"({len(st.restart_times) + 1}/"
                            f"{self.max_restarts} in window)\n")
                        if self.restart_delay:
                            time.sleep(self.restart_delay)
                        st.restart_times.append(self.clock())
                        self._launch(st)
                        n_running += 1
                    else:
                        sys.stderr.write(
                            f"[supervisor] worker {st.spec.rank} exited "
                            f"with code {ret}; restart budget exhausted "
                            f"({self.max_restarts} per "
                            f"{self.restart_window:.0f}s) — failing the "
                            f"job\n")
                        st.failed = True
                        crashed = ret
                if crashed is not None:
                    exit_code = crashed
                    self._drain()
                    break
                if n_running == 0:
                    break
                time.sleep(poll)
        finally:
            if install:
                for sig, h in prev_handlers.items():
                    signal.signal(sig, h)
            for st in self._workers:
                if st.log_fd is not None:
                    st.log_fd.close()
                    st.log_fd = None

        report = self._report(exit_code, interrupted)
        self._emit(report)
        return report

    # -- reporting ------------------------------------------------------
    def _report(self, exit_code, interrupted):
        workers = {}
        for st in self._workers:
            workers[str(st.spec.rank)] = {
                "restarts": len(st.restart_times),
                "exit_codes": list(st.exit_codes),
                "done": st.done,
                "failed": st.failed,
                "drained": st.drained,
                # one assigned flight-dump path per incarnation;
                # "exists" says whether that incarnation actually
                # flushed (watchdog abort / SIGTERM did, a SIGKILL
                # or hard crash did not)
                "flight_dumps": [
                    {"path": p, "exists": os.path.exists(p)}
                    for p in st.flight_dumps],
            }
        undrained = [st.spec.rank for st in self._workers
                     if st.drained is False]
        success = (not interrupted and exit_code == 0
                   and all(st.done for st in self._workers))
        return {
            "success": success,
            "exit_code": exit_code if not interrupted else 143,
            "interrupted": interrupted,
            "restarts_total": sum(len(st.restart_times)
                                  for st in self._workers),
            "undrained_ranks": undrained,
            "workers": workers,
        }

    def _emit(self, report):
        text = json.dumps(report, indent=2, sort_keys=True)
        if self.report_path:
            tmp = self.report_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text + "\n")
            os.replace(tmp, self.report_path)
        sys.stderr.write("[supervisor] report: " + text + "\n")
