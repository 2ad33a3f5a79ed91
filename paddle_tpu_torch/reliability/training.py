"""Checkpoint/resume training: the trainer-restart story.

Counterpart of paddle_tpu/reliability/training.py.
`resilient_train_loop` wraps the port's Executor step loop (on the card
every step after a signature's first replays that entry's captured
graphs) with:

* interval checkpointing through reliability.CheckpointManager (atomic,
  CRC-validated snapshots);
* a SIGTERM hook that finishes the in-flight step, snapshots, and raises
  TrainingInterrupted instead of dying mid-write;
* auto-resume: on entry the loop restores `latest_valid()` into the
  scope and continues from the recorded step — a run killed at step k
  and replayed to the end matches the uninterrupted run's parameters
  (the snapshot carries the optimizer state, not just the weights).

The JAX package preloads the "train" component from the compile cache
in a background thread here. The port has no such preload: an Executor
entry's first run of a signature is its eager warm-up and is the step
itself (it applies the update once), and its graphs are captured on the
next run. A warm-up run outside the loop would apply an update the
uninterrupted run never made, so a resumed worker captures on its first
steps as a fresh one does; with the compile cache armed those captures
record their miss and store events under the "train" attribution.
"""
import contextlib
import signal
import threading
import time

import numpy as np

from paddle_tpu_torch.core import flags as _flags
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.reliability.checkpoint import CheckpointManager
from paddle_tpu_torch.reliability.faults import inject_point

__all__ = ["TrainingInterrupted", "resilient_train_loop"]


class TrainingInterrupted(Exception):
    """SIGTERM landed; state was checkpointed at `step` (resume by calling
    resilient_train_loop again with the same directory). `flight_dump`
    is the flight-recorder dump flushed on the way out (None if it
    failed)."""

    def __init__(self, step, flight_dump=None):
        super().__init__(
            f"training interrupted by SIGTERM; checkpointed at step "
            f"{step} — rerun to resume")
        self.step = step
        self.flight_dump = flight_dump


def _host(value):
    import torch
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class _NumericsMonitor:
    """Per-step numerics telemetry: the global L2 norm over the step's
    float fetches lands in the `pt_train_grad_global_norm` gauge, and a
    non-finite fetch increments `pt_train_nonfinite_total`, with a
    flight-recorder note on the FIRST bad step. Gated by
    PT_FLAGS_train_numerics."""

    def __init__(self):
        from paddle_tpu_torch.observability import metrics as _metrics
        reg = _metrics.registry()
        self._norm = reg.gauge(
            "pt_train_grad_global_norm",
            "global L2 norm over the step's float fetches")
        self._nonfinite = reg.counter(
            "pt_train_nonfinite_total",
            "training steps that fetched a non-finite value")
        self._first_bad_step = None

    def observe(self, step, fetches):
        sq, nonfinite = 0.0, False
        for f in fetches or ():
            a = _host(f)
            if a.dtype.kind != "f":
                continue
            finite = np.isfinite(a)
            if not finite.all():
                nonfinite = True
                a = np.where(finite, a, 0.0)
            sq += float((a.astype(np.float64) ** 2).sum())
        norm = float(np.sqrt(sq))
        self._norm.set(norm)
        if nonfinite:
            self._nonfinite.inc()
            if self._first_bad_step is None:
                self._first_bad_step = step
                from paddle_tpu_torch.observability import recorder
                recorder.flight_recorder().note(
                    f"non-finite training fetch at step {step}",
                    step=step, global_norm=norm)
        return norm, nonfinite

    @property
    def first_bad_step(self):
        return self._first_bad_step


def _dump_flight(reason, step):
    """Best-effort flight-recorder flush (the SIGTERM path), written
    where the supervisor expects it (PT_FLIGHT_DUMP / PT_FLIGHT_DIR)."""
    from paddle_tpu_torch.observability import recorder
    try:
        return recorder.flight_recorder().dump(reason=reason,
                                               extra={"step": step})
    except OSError:
        return None


def resilient_train_loop(executor, program, feed_fn, fetch_list,
                         num_steps, checkpoint_dir, save_every=50,
                         keep=3, manager=None, scope=None, on_step=None,
                         handle_sigterm=True, watchdog=None):
    """Run `num_steps` of `executor.run(program, ...)` with checkpoint /
    resume.

    feed_fn(step) -> feed dict makes the data stream restartable: resume
    replays from the recorded step. on_step(step, fetches) observes each
    completed step. Returns {"resumed_from", "final_step",
    "last_fetches"}.

    SIGTERM handling installs only on the main thread; elsewhere the loop
    still checkpoints on interval. A hung-step watchdog is armed around
    every step when `watchdog` is passed, or when
    PT_FLAGS_watchdog_deadline_s > 0 (abort mode). The per-step
    `inject_point("train.step")` is where chaos plans plant `crash` for
    the supervised-restart drill.
    """
    from paddle_tpu_torch.observability import profile as _profile
    from paddle_tpu_torch.observability import trace as _trace

    enforce(num_steps >= 0, "num_steps must be >= 0")
    mgr = manager or CheckpointManager(checkpoint_dir, keep=keep)
    start = 0
    resumed = mgr.latest_valid()
    if resumed is not None:
        mgr.restore_into_scope(resumed, program=program, scope=scope)
        start = resumed

    wd, own_wd = watchdog, False
    if wd is None:
        deadline = _flags.get_flag("watchdog_deadline_s")
        if deadline and deadline > 0:
            from paddle_tpu_torch.reliability.watchdog import Watchdog
            wd = Watchdog(deadline, mode="abort").start()
            own_wd = True

    stop = threading.Event()
    prev_handler = None
    install = (handle_sigterm
               and threading.current_thread() is threading.main_thread())
    if install:
        prev_handler = signal.signal(signal.SIGTERM,
                                     lambda signum, frame: stop.set())

    numerics = (_NumericsMonitor()
                if _flags.get_flag("train_numerics") else None)
    fetches = None
    try:
        for step in range(start, num_steps):
            scope_cm = (wd.watch(f"train-step-{step}") if wd is not None
                        else contextlib.nullcontext())
            # the train.step span roots the step's trace; the profile
            # attribution files any capture the Executor pays inside the
            # step under component "train"
            with scope_cm, _trace.span("train.step",
                                       attrs={"step": step}), \
                    _profile.attribution("train", key="step"):
                t0 = time.perf_counter()
                fetches = executor.run(program, feed=feed_fn(step),
                                       fetch_list=fetch_list, scope=scope)
                _profile.observe_run("train", "step",
                                     time.perf_counter() - t0)
            done = step + 1
            if numerics is not None:
                numerics.observe(step, fetches)
            if on_step is not None:
                on_step(step, fetches)
            if stop.is_set():
                dump = _dump_flight("sigterm", done)
                mgr.save(done, program=program, scope=scope,
                         meta={"interrupted": True, "flight_dump": dump})
                raise TrainingInterrupted(done, flight_dump=dump)
            if save_every and done % save_every == 0 and done < num_steps:
                mgr.save(done, program=program, scope=scope)
            inject_point("train.step", tag=str(done))
        if num_steps > start:
            mgr.save(num_steps, program=program, scope=scope)
        return {"resumed_from": start, "final_step": num_steps,
                "last_fetches": fetches}
    finally:
        if install:
            signal.signal(signal.SIGTERM, prev_handler)
        if own_wd:
            wd.stop()
