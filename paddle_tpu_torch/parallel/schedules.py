"""Pipeline schedule tables: GPipe fill-drain, 1F1B, interleaved 1F1B.

Counterpart of paddle_tpu/parallel/schedules.py, copied: the tables are
framework-neutral numpy, and the port's tables equal the JAX package's
field for field. The port's pipeline engine (`parallel/pipeline.py`)
runs one rank per stage; rank s executes row s of the table tick by
tick, posting the sends its `send_fwd` / `send_bwd` flags name and the
receives the next tick's `rx_store` / `brx_store` slots expect.

Schedules (S stages, M microbatches, v virtual stages per device):

* ``gpipe``        — fill-drain: all M forwards, a flush, all M backwards
  (LIFO). Per-stage idle is 2(S-1) ticks; activation stash is O(M).
* ``1f1b``         — PipeDream-flush: stage s runs S-s warmup forwards then
  strictly alternates one-backward-one-forward. Same 2(S-1) idle ticks as
  gpipe but the activation stash is bounded by S-s microbatches,
  independent of M, so the engine keeps the autograd graphs of its
  in-flight microbatches instead of recomputing forwards.
* ``interleaved``  — Megatron-style interleaved 1F1B: device d owns the v
  virtual stages {d, d+S, ..., d+(v-1)S}; each is 1/v of the model, so a
  tick costs 1/v as much and the warm-up/drain bubble shrinks to
  2(S-1)/v tick-units. For M % S == 0 the exact Megatron in-order
  sequence is used; uneven M falls back to a greedy variant that stays
  correct at some extra bubble.

Tables carry full operand-routing annotations: rx/brx hold-buffer slots
for wire values that arrive before their consuming tick, residual-stash
slots for in-flight activations, and send flags for the two wires.
"""
import numpy as np

# abstract op kinds (simulation)
_F, _B = 1, 2

# engine branch kinds (the tick dispatch in pipeline.py)
K_IDLE, K_FWD_MID, K_FWD_LAST, K_BWD_MID, K_BWD_LAST = 0, 1, 2, 3, 4

# operand-source sentinels
SRC_FRESH = -2   # fwd input is the fresh microbatch (virtual stage 0)
SRC_SEED = -2    # bwd cotangent is the loss seed (last virtual stage)
NO_SLOT = -1

SCHEDULES = ("gpipe", "1f1b", "interleaved")

_FIELDS = ("kind", "chunk", "mb", "fwd_src", "rx_store", "send_fwd",
           "res_slot", "bwd_src", "brx_store", "send_bwd")


class ScheduleTable:
    """Static (tick × stage) dispatch table plus routing annotations.

    Attributes (numpy int32, shape [T, S]):
      kind      — K_IDLE / K_FWD_MID / K_FWD_LAST / K_BWD_MID / K_BWD_LAST
      chunk     — local virtual-stage index on this device (0..v-1)
      mb        — microbatch index
      fwd_src   — SRC_FRESH, or rx slot holding the input activation
      rx_store  — rx slot to store this tick's fwd-wire arrival (NO_SLOT: none)
      send_fwd  — 1 iff this tick's output goes on the fwd wire
      res_slot  — residual-stash slot (written by fwd, read+freed by bwd);
                  mid-stage and last-stage pools are numbered independently
      bwd_src   — SRC_SEED, or brx slot holding the output cotangent
      brx_store — brx slot to store this tick's bwd-wire arrival
      send_bwd  — 1 iff this tick's input cotangent goes on the bwd wire
    """

    def __init__(self, schedule, S, M, v, grid, fwd_only=False):
        self.schedule = schedule
        self.num_stages = S
        self.num_microbatches = M
        self.virtual_stages = v
        self.fwd_only = fwd_only
        self.T = len(grid)
        for f in _FIELDS:
            setattr(self, f, np.zeros((self.T, S), np.int32))
        self.fwd_src[:] = NO_SLOT
        self.rx_store[:] = NO_SLOT
        self.res_slot[:] = NO_SLOT
        self.bwd_src[:] = NO_SLOT
        self.brx_store[:] = NO_SLOT
        self._annotate(grid)

    # -- construction --------------------------------------------------
    def _annotate(self, grid):
        S, v, J = self.num_stages, self.virtual_stages, \
            self.num_stages * self.virtual_stages
        f_tick, b_tick = {}, {}
        for t, row in enumerate(grid):
            for s, (k, j, m) in enumerate(row):
                if k == _F:
                    f_tick[(j, m)] = t
                elif k == _B:
                    b_tick[(j, m)] = t

        # rx/brx hold buffers: a wire value arrives the tick after its
        # producer ran and is held until its consumer's tick (inclusive;
        # the engine stores arrivals before executing the tick's op, so
        # arrive==consume shares the tick). Slots are per-device.
        rx_alloc = [_SlotPool() for _ in range(S)]
        brx_alloc = [_SlotPool() for _ in range(S)]
        res_mid = [_SlotPool() for _ in range(S)]
        res_last = [_SlotPool() for _ in range(S)]

        for t, row in enumerate(grid):
            for s, (k, j, m) in enumerate(row):
                if k == 0:
                    continue
                c = j // S
                self.chunk[t, s] = c
                self.mb[t, s] = m
                last = (j == J - 1)
                if k == _F:
                    self.kind[t, s] = K_FWD_LAST if last else K_FWD_MID
                    if j == 0:
                        self.fwd_src[t, s] = SRC_FRESH
                    else:
                        arrive = f_tick[(j - 1, m)] + 1
                        slot = rx_alloc[s].alloc(arrive, t)
                        self.rx_store[arrive, s] = slot
                        self.fwd_src[t, s] = slot
                    self.send_fwd[t, s] = 0 if last else 1
                    if not self.fwd_only:
                        pool = res_last[s] if last else res_mid[s]
                        self.res_slot[t, s] = pool.alloc(t, b_tick[(j, m)])
                else:
                    self.kind[t, s] = K_BWD_LAST if last else K_BWD_MID
                    if last:
                        self.bwd_src[t, s] = SRC_SEED
                    else:
                        arrive = b_tick[(j + 1, m)] + 1
                        slot = brx_alloc[s].alloc(arrive, t)
                        self.brx_store[arrive, s] = slot
                        self.bwd_src[t, s] = slot
                    self.send_bwd[t, s] = 0 if j == 0 else 1
                    pool = res_last[s] if last else res_mid[s]
                    self.res_slot[t, s] = pool.find(t)

        self.cap_rx = max(1, max(p.capacity for p in rx_alloc))
        self.cap_brx = max(1, max(p.capacity for p in brx_alloc))
        self.cap_res_mid = max(1, max(p.capacity for p in res_mid))
        self.cap_res_last = max(1, max(p.capacity for p in res_last))

    def stash_bytes(self, act_bytes, wire_bytes=None):
        """Worst-case residual-stash footprint of this schedule on one
        stage, in bytes: rx/brx slots hold WIRE activations (what a
        neighbour sent), residual slots hold full forward activations
        kept for the backward. The static resource planner
        (analysis/planner.py) adds this to its peak-memory estimate so
        pipeline stashes are priced, not just the dataflow graph."""
        wire = act_bytes if wire_bytes is None else wire_bytes
        return (int((self.cap_rx + self.cap_brx) * wire)
                + int((self.cap_res_mid + self.cap_res_last) * act_bytes))

    # -- reporting -----------------------------------------------------
    def stats(self):
        S = self.num_stages
        is_f = (self.kind == K_FWD_MID) | (self.kind == K_FWD_LAST)
        is_b = (self.kind == K_BWD_MID) | (self.kind == K_BWD_LAST)
        inflight = np.cumsum(is_f.astype(np.int64)
                             - is_b.astype(np.int64), axis=0)
        return {
            "schedule": self.schedule,
            "num_stages": S,
            "num_microbatches": self.num_microbatches,
            "virtual_stages": self.virtual_stages,
            "ticks": self.T,
            "busy_fwd": is_f.sum(0).tolist(),
            "busy_bwd": is_b.sum(0).tolist(),
            "idle": (self.kind == K_IDLE).sum(0).tolist(),
            "peak_in_flight": inflight.max(0).tolist(),
            "stash_capacity": {"rx": int(self.cap_rx),
                               "brx": int(self.cap_brx),
                               "res_mid": int(self.cap_res_mid),
                               "res_last": int(self.cap_res_last)},
        }

    def counters(self):
        """stats() flattened to the scalar counters the profiler /
        metrics-registry series carry (pipeline/<schedule> in
        `profiler.counters()`; pt_profiler_counter gauges in /metrics):
        total busy/idle ticks and the peak in-flight bound across
        stages. The bubble model is priced by the caller (it needs the
        pipe's remat/residual configuration)."""
        stats = self.stats()
        return {
            "ticks": stats["ticks"],
            "busy_fwd": sum(stats["busy_fwd"]),
            "busy_bwd": sum(stats["busy_bwd"]),
            "idle": sum(stats["idle"]),
            "peak_in_flight": max(stats["peak_in_flight"]),
        }

    def tick_profile(self):
        """Tick-level shape of the table for measured-time attribution
        (observability/profile.py): how many ticks contain any backward
        work vs forward-only work vs none. Under the lockstep model a
        tick's wall cost is the max over stages, so a tick with ANY bwd
        slot costs ~t_bwd and a busy bwd-free tick costs ~t_fwd — the
        two unknowns `Pipeline.measured_tick_times` solves from
        measured scan walls."""
        is_f = (self.kind == K_FWD_MID) | (self.kind == K_FWD_LAST)
        is_b = (self.kind == K_BWD_MID) | (self.kind == K_BWD_LAST)
        any_f = is_f.any(1)
        any_b = is_b.any(1)
        return {
            "ticks": int(self.T),
            "bwd_ticks": int(any_b.sum()),
            "fwd_only_ticks": int((any_f & ~any_b).sum()),
            "idle_ticks": int((~any_f & ~any_b).sum()),
        }

    def bubble_fraction(self, t_fwd=1.0, t_bwd=2.0, recompute_in_bwd=None):
        """Analytic bubble under the lockstep-tick model.

        Every tick, all devices advance together (the two `ppermute`s are
        a barrier), so a tick costs the MAX over devices of the work in
        it. A virtual stage is 1/v of the model, so its fwd costs
        t_fwd/v. When the engine rematerialises the forward inside
        backward ticks (`recompute_in_bwd`), a bwd slot costs
        (t_fwd+t_bwd)/v but only t_bwd/v of it is useful work — the
        recompute is charged to the bubble, which is what makes the
        measured fill-drain bubble exceed the textbook (S-1)/(M+S-1).
        """
        if recompute_in_bwd is None:
            recompute_in_bwd = self.schedule == "gpipe"
        v = self.virtual_stages
        is_f = (self.kind == K_FWD_MID) | (self.kind == K_FWD_LAST)
        is_b = (self.kind == K_BWD_MID) | (self.kind == K_BWD_LAST)
        w_b = (t_bwd + t_fwd) if recompute_in_bwd else t_bwd
        cost = is_f * (t_fwd / v) + is_b * (w_b / v)
        total = cost.max(1).sum() * self.num_stages
        useful = (is_f.sum() * t_fwd + is_b.sum() * t_bwd) / v
        return float(1.0 - useful / total) if total else 0.0


class _SlotPool:
    """Interval slot allocator: a slot busy on [start, end] may be reused
    by an interval starting strictly after `end`."""

    def __init__(self):
        self._busy = []          # per slot: release tick (end)
        self._live = {}          # start -> slot (for find())
        self._by_start = {}

    @property
    def capacity(self):
        return len(self._busy)

    def alloc(self, start, end):
        for slot, free_after in enumerate(self._busy):
            if free_after < start:
                self._busy[slot] = end
                self._by_start[(start, end)] = slot
                self._live[start] = slot
                return slot
        self._busy.append(end)
        slot = len(self._busy) - 1
        self._by_start[(start, end)] = slot
        self._live[start] = slot
        return slot

    def find(self, end):
        """Slot of the interval that ends at `end` (bwd reads the slot its
        fwd allocated)."""
        for (s, e), slot in self._by_start.items():
            if e == end:
                return slot
        raise KeyError(end)


# ---------------------------------------------------------------------------
# schedule generation
# ---------------------------------------------------------------------------
def make_schedule(schedule, num_stages, num_microbatches, virtual_stages=1,
                  fwd_only=False):
    """Build the ScheduleTable for one training (or forward-only) step."""
    S, M, v = int(num_stages), int(num_microbatches), int(virtual_stages)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"choose from {SCHEDULES}")
    if M < 1 or S < 1:
        raise ValueError(f"need M>=1, S>=1 (got M={M}, S={S})")
    if schedule == "interleaved":
        if v < 2:
            raise ValueError("interleaved schedule needs virtual_stages>=2")
    elif v != 1:
        raise ValueError(f"{schedule} schedule requires virtual_stages=1")

    if fwd_only:
        grid = _greedy(S, M, v, prefer_bwd=False, include_bwd=False)
    elif schedule == "gpipe":
        grid = _gpipe(S, M)
    elif schedule == "1f1b":
        grid = _greedy(S, M, 1, prefer_bwd=True,
                       cap=lambda s: S - s)
    elif M % S == 0:
        grid = _megatron_interleaved(S, M, v)
    else:
        # uneven remainder: the Megatron in-order sequence deadlocks when
        # M % S != 0; the greedy variant completes with extra bubble
        grid = _greedy(S, M, v, prefer_bwd=True)
    return ScheduleTable(schedule, S, M, v, grid, fwd_only=fwd_only)


def _gpipe(S, M):
    """Fill-drain: forward wavefront, flush, LIFO backward wavefront."""
    grid = [[(0, -1, -1)] * S for _ in range(2 * (M + S - 1))]
    for m in range(M):
        for s in range(S):
            grid[s + m][s] = (_F, s, m)
    off = M + S - 1
    for i, m in enumerate(reversed(range(M))):
        for s in range(S):
            grid[off + (S - 1 - s) + i][s] = (_B, s, m)
    return grid


def _greedy(S, M, v, prefer_bwd, cap=None, include_bwd=True):
    """Lockstep greedy list scheduler; used for 1f1b (with the S-s
    in-flight cap that bounds the stash), uneven-M interleaved, and
    forward-only tables."""
    J = v * S
    done_f, done_b = {}, {}
    in_flight = [0] * S
    grid = []
    total = J * M * (2 if include_bwd else 1)
    ndone, t = 0, 0
    while ndone < total:
        if t > 4 * (J * M + J + S) + 16:  # pragma: no cover - safety net
            raise RuntimeError(f"schedule generation stalled "
                               f"({schedule_desc(S, M, v)})")
        row = []
        for s in range(S):
            js = range(s, J, S)
            pick = None
            if include_bwd and prefer_bwd:
                cands = [(j, m) for j in js for m in range(M)
                         if _bwd_ready(done_f, done_b, J, j, m, t)]
                if cands:
                    j, m = min(cands, key=lambda c: (c[1] // S, -c[0],
                                                     c[1] % S))
                    pick = (_B, j, m)
            if pick is None and (cap is None or in_flight[s] < cap(s)):
                cands = [(j, m) for j in js for m in range(M)
                         if _fwd_ready(done_f, j, m, t)]
                if cands:
                    j, m = min(cands, key=lambda c: (c[1] // S, c[0] // S,
                                                     c[1] % S))
                    pick = (_F, j, m)
            row.append(pick or (0, -1, -1))
        for s, (k, j, m) in enumerate(row):
            if k == _F:
                done_f[(j, m)] = t
                in_flight[s] += 1
                ndone += 1
            elif k == _B:
                done_b[(j, m)] = t
                in_flight[s] -= 1
                ndone += 1
        grid.append(row)
        t += 1
    return grid


def _megatron_interleaved(S, M, v):
    """Megatron-LM interleaved 1F1B in-order sequences (schedules.py,
    Narayanan et al. 2021), executed on the lockstep tick grid with
    stalls. Requires M % S == 0."""
    J = v * S

    def order(s):
        total = M * v
        W = min((S - s - 1) * 2 + (v - 1) * S, total)

        def f_op(k):
            return (_F, ((k % (S * v)) // S) * S + s,
                    (k // (S * v)) * S + k % S)

        def b_op(k):
            return (_B, (v - 1 - (k % (S * v)) // S) * S + s,
                    (k // (S * v)) * S + k % S)

        seq = [f_op(k) for k in range(W)]
        for i in range(total - W):
            seq.append(f_op(W + i))
            seq.append(b_op(i))
        seq.extend(b_op(i) for i in range(total - W, total))
        return seq

    seqs = [order(s) for s in range(S)]
    ptr = [0] * S
    done_f, done_b = {}, {}
    grid, ndone, t = [], 0, 0
    total = 2 * J * M
    while ndone < total:
        if t > 4 * (J * M + J + S) + 16:
            raise RuntimeError(
                f"interleaved schedule stalled ({schedule_desc(S, M, v)}); "
                "M % S != 0 must use the greedy fallback")
        row = []
        for s in range(S):
            pick = (0, -1, -1)
            if ptr[s] < len(seqs[s]):
                k, j, m = seqs[s][ptr[s]]
                ok = (_fwd_ready(done_f, j, m, t) if k == _F
                      else _bwd_ready(done_f, done_b, J, j, m, t))
                if ok:
                    pick = (k, j, m)
            row.append(pick)
        for s, (k, j, m) in enumerate(row):
            if k:
                ptr[s] += 1
                ndone += 1
                (done_f if k == _F else done_b)[(j, m)] = t
        grid.append(row)
        t += 1
    return grid


def _fwd_ready(done_f, j, m, t):
    if (j, m) in done_f:
        return False
    return j == 0 or done_f.get((j - 1, m), t) < t


def _bwd_ready(done_f, done_b, J, j, m, t):
    if (j, m) in done_b or (j, m) not in done_f or done_f[(j, m)] >= t:
        return False
    return j == J - 1 or done_b.get((j + 1, m), t) < t


def schedule_desc(S, M, v):
    return f"S={S} M={M} v={v}"


def validate_table(table):
    """Structural invariants — every (vstage, microbatch) fwd/bwd exactly
    once, dependencies respected, slots coherent. Raises AssertionError."""
    S, M, v = table.num_stages, table.num_microbatches, table.virtual_stages
    J = S * v
    f_at, b_at = {}, {}
    for t in range(table.T):
        for s in range(S):
            k = table.kind[t, s]
            if k == K_IDLE:
                continue
            j = table.chunk[t, s] * S + s
            m = table.mb[t, s]
            if k in (K_FWD_MID, K_FWD_LAST):
                assert (j, m) not in f_at, f"fwd({j},{m}) twice"
                assert (k == K_FWD_LAST) == (j == J - 1)
                if j > 0:
                    assert f_at[(j - 1, m)] < t, f"fwd({j},{m}) before input"
                f_at[(j, m)] = t
            else:
                assert (j, m) not in b_at, f"bwd({j},{m}) twice"
                assert (k == K_BWD_LAST) == (j == J - 1)
                assert f_at[(j, m)] < t
                if j < J - 1:
                    assert b_at[(j + 1, m)] < t
                b_at[(j, m)] = t
    assert len(f_at) == J * M, f"{len(f_at)} fwd ops != {J * M}"
    if not table.fwd_only:
        assert len(b_at) == J * M
    return True
