"""Continuous batching for autoregressive generation serving.

Counterpart of paddle_tpu/serving/generation.py. `ContinuousBatcher`
admits and retires requests at **step granularity** over a fixed slot
bank:

* a free slot refills from the queue mid-flight — the newcomer is
  prefilled into its slot (`DecodeEngine.prefill` touches only that
  slot's cache rows; running slots are untouched);
* a finished slot returns immediately (stop token, token budget, or a
  vanished streaming client) and the next queued request takes it on the
  same tick;
* every slot streams: tokens land in the request's queue as they are
  produced, so time-to-first-token is one prefill, not one batch drain.

`PagedBatcher` does the same over a `PagedDecodeEngine`, with parking
admission, prefix-hit accounting and the draft/verify speculative tick.

The decode loop runs on ONE driver thread (engine state is
single-owner; clients only touch their request's queue), is fake-clock
testable through `step()`, and reports through the unified metrics
registry (`pt_generation_*`) plus `serving.decode_step` /
`serving.generate` spans.

Chaos choke points: `generation.prefill`, `generation.decode_step`,
`generation.block_alloc`, `generation.draft_step` and
`generation.verify_step` (reliability/faults.py KNOWN_SITES).

Not ported yet: resumable snapshots (`admit_resumed`,
`snapshot_requests`, `submit_resumed`) and the paged degradation ladder,
whose middle rungs need the spill tier: under pool pressure admission
parks, which was the ladder's last rung.
"""
import collections
import itertools
import threading
import time

import numpy as np

from paddle_tpu_torch.analysis.concurrency import make_condition
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.observability import metrics as obs_metrics
from paddle_tpu_torch.observability import trace as obs_trace
from paddle_tpu_torch.ops.generation import (
    PagedDecodeEngine, PoolExhausted, greedy_verify, rejection_verify,
    select_token,
)
from paddle_tpu_torch.reliability.faults import FaultError, inject_point
from paddle_tpu_torch.serving.batcher import (
    QueueFullError, RequestTimeout, ServerClosed, ServingError,
)
from paddle_tpu_torch.utils.metrics import Counter, LatencyStat

__all__ = [
    "GenerationAborted", "GenerationRequest", "ContinuousBatcher",
    "PagedBatcher", "GenerationServer", "lockstep_generate",
]

#: terminal stop causes recorded per request and counted in
#: pt_generation_stops_total{cause=}
STOP_CAUSES = ("stop_token", "max_tokens", "client_gone", "shutdown",
               "fault")


class GenerationAborted(ServingError):
    """The generation was aborted before finishing (client vanished,
    injected fault, or shutdown without drain)."""


class GenerationRequest:
    """One streaming generation request.

    Producers (the decode driver) append tokens; the consumer either
    iterates `stream()` (the gateway's per-token path) or blocks in
    `result()` for the full sequence. `cancel()` marks the request
    abandoned — the driver frees its slot at the next step boundary
    (the dropped-streaming-client path). All consumer-side state is
    private to this request, so a slow reader never stalls the decode
    loop."""

    def __init__(self, prompt, max_new_tokens, enqueued_at,
                 stop_token=None, mode="greedy", temperature=1.0,
                 seed=0, deadline=None, tenant=None, trace_ctx=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        enforce(self.prompt.size >= 1, "empty prompt")
        enforce(max_new_tokens >= 1, "max_new_tokens must be >= 1")
        enforce(mode in ("greedy", "sample"),
                "mode must be greedy|sample, got %r", mode)
        self.max_new_tokens = int(max_new_tokens)
        self.stop_token = stop_token
        self.mode = mode
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.deadline = deadline
        self.tenant = tenant
        self.trace_ctx = trace_ctx
        self.enqueued_at = enqueued_at
        self.first_token_at = None          # set by the driver (TTFT)
        self.request_id = None              # stamped at submit()
        self.tokens = []
        self.stop_cause = None
        self.span = None                    # serving.generate span
        self._rng = (np.random.RandomState(self.seed)
                     if mode == "sample" else None)
        self._cond = make_condition("serving.generation.request")
        self._stream = collections.deque()
        self._done = False
        self._error = None
        self._cancelled = False

    # -- driver side ---------------------------------------------------
    def _push(self, token):
        self.tokens.append(int(token))
        with self._cond:
            self._stream.append(int(token))
            self._cond.notify_all()

    def _finish(self, stop_cause, error=None):
        with self._cond:
            if self._done:            # first terminal cause wins
                return
            self.stop_cause = stop_cause
            self._done = True
            self._error = error
            self._cond.notify_all()
        sp = self.span
        if sp is not None:
            self.span = None
            sp.set_attribute("tokens", len(self.tokens))
            sp.set_attribute("stop_cause", stop_cause)
            sp.finish(error=error)

    def pick(self, logits_row):
        """Select this request's next token from its logits row (greedy
        argmax or its own seeded sampler)."""
        return select_token(logits_row, self.mode,
                            temperature=self.temperature, rng=self._rng)

    # -- consumer side -------------------------------------------------
    def cancel(self):
        """Abandon the request (client went away). The slot is released
        at the next step boundary; already-produced tokens stay
        readable."""
        self._cancelled = True
        with self._cond:
            self._cond.notify_all()

    @property
    def cancelled(self):
        return self._cancelled

    def done(self):
        with self._cond:
            return self._done

    def stream(self, timeout=None):
        """Yield tokens as they are produced until the request ends.
        Raises the terminal error (if any) after the last token;
        `timeout` bounds the wait for EACH next token."""
        idx = 0
        while True:
            with self._cond:
                while len(self._stream) <= idx and not self._done:
                    if not self._cond.wait(timeout):
                        raise RequestTimeout(
                            f"no token within {timeout}s")
                if len(self._stream) > idx:
                    tok = self._stream[idx]
                    idx += 1
                else:
                    if self._error is not None:
                        raise self._error
                    return
            yield tok

    def result(self, timeout=None):
        """Block until the request finishes; returns {"tokens",
        "stop_cause", "ttft_s"} or raises the terminal error."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise RequestTimeout(
                    f"generation not finished within {timeout}s")
            if self._error is not None:
                raise self._error
        ttft = (None if self.first_token_at is None
                else self.first_token_at - self.enqueued_at)
        return {"tokens": list(self.tokens),
                "stop_cause": self.stop_cause, "ttft_s": ttft}


class _Slot:
    __slots__ = ("request", "last_token", "produced")

    def __init__(self, request):
        self.request = request
        self.last_token = 0
        self.produced = 0


class ContinuousBatcher:
    """Step-granular admission/retirement over a DecodeEngine slot bank.

    Synchronous and clock-parameterised: `step(now)` performs one decode
    tick — refill free slots from the queue (prefill newcomers), advance
    every live slot one token, retire finished slots — with no threads
    involved, which is what the deterministic tests drive.
    `GenerationServer` wraps it in a driver thread for real traffic.
    """

    def __init__(self, engine, max_queue=128, clock=time.monotonic):
        self.engine = engine
        self.max_queue = int(max_queue)
        self._clock = clock
        self._cond = make_condition("serving.generation.batcher")
        self._pending = collections.deque()
        self._closed = False
        self._draining = False
        self._state = engine.init_state()
        self._slots = [None] * engine.batch_size
        self._tokens = np.zeros(engine.batch_size, np.int32)
        self._active = np.zeros(engine.batch_size, bool)
        self._steps = 0
        # instance counters (stats()) — mirrored process-wide into the
        # registry as pt_generation_total{field=} by the Counter shim
        self.counters = Counter("generation", (
            "submitted", "completed", "rejected", "cancelled", "failed",
            "refills", "steps", "tokens", "prefill_faults",
            "step_faults"))
        self._rid_seq = itertools.count(1)
        self._ttft = LatencyStat("generation_ttft_s")
        self._step_lat = LatencyStat("generation_step_s")
        reg = obs_metrics.registry()
        self._obs_stops = reg.counter(
            "pt_generation_stops_total",
            "terminal stop causes per generation request",
            labels=("cause",))
        self._obs_live = reg.gauge(
            "pt_generation_slots_live",
            "decode slots occupied by a live request")
        self._obs_occupancy = reg.histogram(
            "pt_generation_occupancy",
            "live slots / slot bank size per decode step",
            lo=1e-3, hi=2.0)

    # -- producer side -------------------------------------------------
    def submit(self, request):
        """Enqueue a GenerationRequest (bounded queue). Raises
        ServerClosed after close(), QueueFullError at capacity, and
        rejects prompts that cannot fit the engine's (batch, max_len)
        rung up front."""
        total = request.prompt.size + request.max_new_tokens
        enforce(request.prompt.size <= self.engine.buckets[-1],
                "prompt length %d exceeds the largest prefill bucket %d",
                request.prompt.size, self.engine.buckets[-1])
        enforce(total <= self.engine.max_len,
                "prompt %d + max_new_tokens %d exceeds the engine "
                "max_len rung %d — route to a longer rung",
                request.prompt.size, request.max_new_tokens,
                self.engine.max_len)
        with self._cond:
            if self._closed:
                raise ServerClosed("generation server is shut down")
            if len(self._pending) >= self.max_queue:
                self.counters.inc("rejected")
                raise QueueFullError(
                    f"generation queue full ({self.max_queue} pending)")
            if request.request_id is None:
                request.request_id = f"gen-{next(self._rid_seq)}"
            self._pending.append(request)
            self.counters.inc("submitted")
            self._cond.notify_all()
        return request

    @property
    def queue_depth(self):
        with self._cond:
            return len(self._pending)

    @property
    def live_slots(self):
        return int(self._active.sum())

    # -- the decode tick -----------------------------------------------
    def _free_slot_indices(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _retire(self, idx, cause, error=None, now=None):
        slot = self._slots[idx]
        if slot is None:              # already retired (shutdown race)
            return
        self._slots[idx] = None
        self._active[idx] = False
        # keep the gauge honest at the FINAL retirement too — a stale
        # non-zero slots_live with no token progress reads as a wedged
        # stream to the freshness SLO
        self._obs_live.set(int(self._active.sum()))
        self._obs_stops.labels(cause=cause).inc()
        if error is None and cause in ("stop_token", "max_tokens"):
            self.counters.inc("completed")
        elif cause == "client_gone":
            self.counters.inc("cancelled")
        else:
            self.counters.inc("failed")
        slot.request._finish(cause, error=error)

    def _admit_one(self, req, idx, now):
        if req.cancelled:
            req._finish("client_gone",
                        error=GenerationAborted("cancelled in queue"))
            self._obs_stops.labels(cause="client_gone").inc()
            self.counters.inc("cancelled")
            return
        if req.deadline is not None and now >= req.deadline:
            req._finish("fault", error=RequestTimeout(
                "generation request expired in queue"))
            self._obs_stops.labels(cause="fault").inc()
            self.counters.inc("failed")
            return
        req.span = obs_trace.start_span(
            "serving.generate", parent=req.trace_ctx,
            attrs={"slot": idx, "prompt_len": int(req.prompt.size),
                   "max_new_tokens": req.max_new_tokens,
                   "mode": req.mode})
        try:
            # chaos: a prefill fault fails THIS admission; the slot and
            # every running request survive
            inject_point("generation.prefill", tag=f"s{idx}")
            self._state, logits = self.engine.prefill(
                self._state, idx, req.prompt)
        except FaultError as e:
            self.counters.inc("prefill_faults")
            req._finish("fault", error=GenerationAborted(
                f"prefill fault: {e}"))
            self._obs_stops.labels(cause="fault").inc()
            self.counters.inc("failed")
            return
        slot = _Slot(req)
        self._slots[idx] = slot
        self._active[idx] = True
        self.counters.inc("refills")
        req.first_token_at = self._clock()
        self._ttft.update(req.first_token_at - req.enqueued_at)
        tok = req.pick(logits)
        self._emit(idx, slot, tok)

    def _emit(self, idx, slot, token):
        """Deliver one produced token and retire the slot if it ended."""
        req = slot.request
        slot.last_token = int(token)
        self._tokens[idx] = int(token)
        slot.produced += 1
        req._push(token)
        self.counters.inc("tokens")
        if req.stop_token is not None and int(token) == req.stop_token:
            self._retire(idx, "stop_token")
        elif slot.produced >= req.max_new_tokens:
            self._retire(idx, "max_tokens")

    def step(self, now=None):
        """One decode tick. Returns the number of live slots after the
        tick (0 = idle; the driver can sleep)."""
        now = self._clock() if now is None else now
        # 1) retire vanished clients BEFORE refilling, so their slots
        #    are reusable on this very tick
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.request.cancelled:
                self._retire(i, "client_gone",
                             error=GenerationAborted("client went away"))
        # 2) refill free slots from the queue (mid-flight admission)
        free = self._free_slot_indices()
        while free:
            with self._cond:
                if not self._pending:
                    break
                req = self._pending.popleft()
            self._admit_one(req, free[0], now)
            free = self._free_slot_indices()
        live = int(self._active.sum())
        self._obs_live.set(live)
        if live == 0:
            return 0
        self._obs_occupancy.record(live / self.engine.batch_size)
        # 3) one decode step for every live slot
        oldest = min((s.request for s in self._slots if s is not None),
                     key=lambda r: r.enqueued_at)
        step_span = obs_trace.start_span(
            "serving.decode_step", parent=oldest.trace_ctx,
            attrs={"live_slots": live,
                   "occupancy": round(live / self.engine.batch_size, 4),
                   "step": self._steps})
        t0 = self._clock()
        try:
            # chaos: a decode fault skips the tick; the cache carry was
            # not advanced, so the retried step is exact
            inject_point("generation.decode_step")
            self._state, logits = self.engine.step(
                self._state, self._tokens, self._active)
        except FaultError as e:
            self.counters.inc("step_faults")
            step_span.finish(error=e)
            return live
        self._steps += 1
        self.counters.inc("steps")
        self._step_lat.update(self._clock() - t0)
        step_span.finish()
        for i, slot in enumerate(self._slots):
            if slot is None or not self._active[i]:
                continue
            self._emit(i, slot, slot.request.pick(logits[i]))
        return int(self._active.sum())

    # -- shutdown ------------------------------------------------------
    def close(self, drain=True):
        """Stop accepting. drain=True lets queued + running requests
        finish (the driver keeps stepping until idle); drain=False
        aborts them with GenerationAborted."""
        with self._cond:
            self._closed = True
            self._draining = drain
            rejected = [] if drain else list(self._pending)
            if not drain:
                self._pending.clear()
            self._cond.notify_all()
        for req in rejected:
            req._finish("shutdown", error=ServerClosed(
                "generation server shut down before start"))
            self._obs_stops.labels(cause="shutdown").inc()
            self.counters.inc("cancelled")
        if not drain:
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    self._retire(i, "shutdown", error=GenerationAborted(
                        "generation server shut down mid-stream"))

    @property
    def closed(self):
        with self._cond:
            return self._closed

    def idle(self):
        with self._cond:
            return not self._pending and self.live_slots == 0

    def stats(self):
        return {
            "queue_depth": self.queue_depth,
            "live_slots": self.live_slots,
            "slot_bank": self.engine.batch_size,
            "max_len": self.engine.max_len,
            "prompt_buckets": list(self.engine.buckets),
            "counters": self.counters.eval(),
            "ttft_s": self._ttft.eval(),
            "step_s": self._step_lat.eval(),
        }




class PagedBatcher(ContinuousBatcher):
    """Continuous batching over a PagedDecodeEngine: block-table KV,
    prefix-reuse admission, and (optionally) draft/verify speculative
    decoding.

    The tick differs from the contiguous batcher in three ways:

    * **Parking admission.** Refill PEEKS the queue head and only pops
      it once `engine.admit` succeeds — a `PoolExhausted` admission
      (atomic: no blocks taken) leaves the request AT THE HEAD and
      stops refilling, preserving FIFO while retirement returns
      blocks. Parking cannot deadlock: a fully idle pool always covers
      one admission (submit enforces prompt+budget ≤ max_len).
    * **Prefix hits.** Admission reports the blocks shared from the
      pool's chain-hash prefix index; the batcher counts them
      (`pt_generation_prefix_hits_total`) and stamps the request
      (`prefix_shared_blocks`).
    * **The speculative tick.** With a draft, each live slot proposes
      up to k tokens (capped by its remaining budget and block
      capacity); ONE chunk=k+1 verify steps the whole batch, then the
      per-slot acceptance rule (greedy: exact; sample: rejection rule,
      distribution-exact) emits accepted+1 tokens and commits exactly
      that many positions. A faulted draft (`generation.draft_step`)
      degrades the tick to plain chunk=1 decoding — same tokens, fewer
      per tick; a faulted verify (`generation.verify_step`) skips the
      tick with the committed lengths untouched, so the retry is exact.
    """

    def __init__(self, engine, draft=None, spec_k=None,
                 prefix_reuse=True, max_queue=128, clock=time.monotonic):
        enforce(isinstance(engine, PagedDecodeEngine),
                "PagedBatcher needs a PagedDecodeEngine, got %s",
                type(engine).__name__)
        super().__init__(engine, max_queue=max_queue, clock=clock)
        self.draft = draft
        self.spec_k = (int(engine.spec_k) if spec_k is None
                       else int(spec_k))
        if draft is None:
            self.spec_k = 0
        # warmup() runs exactly chunks {1, engine.spec_k+1}; keep the
        # verify rung the one the engine warmed
        enforce(self.spec_k in (0, engine.spec_k),
                "spec_k %d would verify at chunk %d, but warmup() only "
                "runs chunk %d — pass spec_k=0 (plain decode) or match "
                "the engine",
                self.spec_k, self.spec_k + 1, engine.spec_k + 1)
        self.prefix_reuse = bool(prefix_reuse)
        self.spec_counters = Counter("generation_spec", (
            "proposed", "accepted", "verify_ticks", "plain_ticks",
            "draft_faults", "verify_faults", "parked",
            "prefix_hit_admissions"))
        reg = obs_metrics.registry()
        self._obs_accepted = reg.counter(
            "pt_generation_accepted_tokens_total",
            "draft proposals accepted by the verify step")
        self._obs_prefix_hits = reg.counter(
            "pt_generation_prefix_hits_total",
            "prompt blocks served from the prefix index at admission")
        self._obs_blocks_live = reg.gauge(
            "pt_generation_blocks_live",
            "KV pool blocks referenced by live slots")
        self._obs_blocks_free = reg.gauge(
            "pt_generation_blocks_free",
            "KV pool blocks on the free stack")

    def _sync_block_gauges(self):
        pool = self.engine.pool
        self._obs_blocks_live.set(pool.live_count())
        self._obs_blocks_free.set(pool.free_count())

    def _retire(self, idx, cause, error=None, now=None):
        # free the slot's blocks FIRST (shared ones drop a reference;
        # complete prompt blocks stay cached in the prefix index)
        if self._slots[idx] is not None:
            self.engine.free_slot(idx)
        super()._retire(idx, cause, error=error, now=now)
        self._sync_block_gauges()

    def _admit_paged(self, req, idx, now):
        """Admit the queue-head request into a free slot. Returns
        "parked" (leave it at the head), else the request was consumed
        (admitted, cancelled, expired, or faulted)."""
        if req.cancelled:
            req._finish("client_gone",
                        error=GenerationAborted("cancelled in queue"))
            self._obs_stops.labels(cause="client_gone").inc()
            self.counters.inc("cancelled")
            return "consumed"
        if req.deadline is not None and now >= req.deadline:
            req._finish("fault", error=RequestTimeout(
                "generation request expired in queue"))
            self._obs_stops.labels(cause="fault").inc()
            self.counters.inc("failed")
            return "consumed"
        total = int(req.prompt.size) + req.max_new_tokens
        try:
            # chaos: a block_alloc fault fails THIS admission (blocks
            # untouched — admit allocates after the site); a prefill
            # fault likewise. Exhaustion is NOT a fault: park.
            inject_point("generation.block_alloc", tag=f"s{idx}")
            inject_point("generation.prefill", tag=f"s{idx}")
            self._state, logits, info = self.engine.admit(
                self._state, idx, req.prompt, total,
                prefix_reuse=self.prefix_reuse)
        except PoolExhausted:
            self.spec_counters.inc("parked")
            return "parked"
        except FaultError as e:
            self.counters.inc("prefill_faults")
            req._finish("fault", error=GenerationAborted(
                f"admission fault: {e}"))
            self._obs_stops.labels(cause="fault").inc()
            self.counters.inc("failed")
            return "consumed"
        req.span = obs_trace.start_span(
            "serving.generate", parent=req.trace_ctx,
            attrs={"slot": idx, "prompt_len": int(req.prompt.size),
                   "max_new_tokens": req.max_new_tokens,
                   "mode": req.mode,
                   "prefix_shared_blocks": info["shared_blocks"]})
        req.prefix_shared_blocks = info["shared_blocks"]
        req.spec_proposed = 0
        req.spec_accepted = 0
        if info["shared_blocks"]:
            self._obs_prefix_hits.inc(info["shared_blocks"])
            self.spec_counters.inc("prefix_hit_admissions")
        if self.draft is not None:
            self.draft.observe(req.prompt)
        slot = _Slot(req)
        self._slots[idx] = slot
        self._active[idx] = True
        self.counters.inc("refills")
        req.first_token_at = self._clock()
        self._ttft.update(req.first_token_at - req.enqueued_at)
        self._sync_block_gauges()
        self._emit(idx, slot, req.pick(logits))
        return "consumed"

    def _draft_for(self, idx, slot):
        """This slot's draft proposals for the tick, capped so emitted
        tokens (accepted+1) can never overrun the token budget or the
        slot's allocated blocks."""
        req = slot.request
        cap = self.engine.slot_capacity(idx)
        ki = min(self.spec_k,
                 int(cap - self.engine.lengths[idx] - 1),
                 req.max_new_tokens - slot.produced - 1)
        if ki <= 0:
            return []
        ctx = list(req.prompt) + req.tokens
        if req.mode == "greedy":
            return [(t, None) for t in self.draft.propose(ctx, ki)]
        return self.draft.propose_sampled(ctx, ki, req._rng)

    def _emit_verified(self, idx, slot, emitted, accepted, proposed):
        """Deliver a verify outcome: commit exactly the consumed
        positions, stream the tokens (stopping at retirement — a
        stop-token mid-chunk retires the slot and the chunk's tail is
        discarded with its dead KV)."""
        req = slot.request
        req.spec_proposed += proposed
        req.spec_accepted += accepted
        self.spec_counters.inc("proposed", proposed)
        self.spec_counters.inc("accepted", accepted)
        self._obs_accepted.inc(accepted)
        if self.draft is not None and emitted:
            self.draft.observe(list(req.prompt) + req.tokens + emitted,
                               n_new=len(emitted))
        consumed = 0
        for tok in emitted:
            self._emit(idx, slot, tok)
            consumed += 1
            if self._slots[idx] is None:     # retired mid-chunk
                return
        self.engine.advance(idx, consumed)

    def step(self, now=None):
        """One paged decode tick: retire vanished clients, refill with
        parking admission, then either a speculative draft/verify step
        or a plain chunk=1 step for every live slot."""
        now = self._clock() if now is None else now
        for i, slot in enumerate(self._slots):
            if slot is not None and slot.request.cancelled:
                self._retire(i, "client_gone",
                             error=GenerationAborted("client went away"))
        free = self._free_slot_indices()
        while free:
            with self._cond:
                if not self._pending:
                    break
                req = self._pending[0]       # peek: park keeps FIFO
            if self._admit_paged(req, free[0], now) == "parked":
                break
            with self._cond:
                if self._pending and self._pending[0] is req:
                    self._pending.popleft()
            free = self._free_slot_indices()
        live = int(self._active.sum())
        self._obs_live.set(live)
        if live == 0:
            return 0
        self._obs_occupancy.record(live / self.engine.batch_size)
        proposals = {}
        if self.spec_k > 0 and self.draft is not None:
            try:
                # chaos: a faulted draft degrades this tick to plain
                # decoding — same emitted tokens, one per slot
                inject_point("generation.draft_step")
                for i, slot in enumerate(self._slots):
                    if slot is not None and self._active[i]:
                        props = self._draft_for(i, slot)
                        if props:
                            proposals[i] = props
            except FaultError:
                self.spec_counters.inc("draft_faults")
                proposals = {}
        oldest = min((s.request for s in self._slots if s is not None),
                     key=lambda r: r.enqueued_at)
        step_span = obs_trace.start_span(
            "serving.decode_step", parent=oldest.trace_ctx,
            attrs={"live_slots": live,
                   "occupancy": round(live / self.engine.batch_size, 4),
                   "step": self._steps,
                   "speculative": bool(proposals)})
        t0 = self._clock()
        if not proposals:
            # plain paged tick (chunk=1) — also the draft-fault
            # degradation path
            try:
                inject_point("generation.decode_step")
                self._state, logits = self.engine.step(
                    self._state, self._tokens, self._active)
            except FaultError as e:
                self.counters.inc("step_faults")
                step_span.finish(error=e)
                return live
            self._steps += 1
            self.counters.inc("steps")
            self.spec_counters.inc("plain_ticks")
            self._step_lat.update(self._clock() - t0)
            step_span.finish()
            for i, slot in enumerate(self._slots):
                if slot is None or not self._active[i]:
                    continue
                tok = slot.request.pick(logits[i])
                if self.draft is not None:
                    self.draft.observe(
                        list(slot.request.prompt) + slot.request.tokens
                        + [tok], n_new=1)
                self._emit(i, slot, tok)
            return int(self._active.sum())
        # speculative tick: ONE chunk=spec_k+1 verify for the batch
        # (always the warmed rung — shorter proposal lists are masked)
        chunk = self.spec_k + 1
        tokens = np.zeros((self.engine.batch_size, chunk), np.int32)
        counts = np.zeros(self.engine.batch_size, np.int32)
        for i, slot in enumerate(self._slots):
            if slot is None or not self._active[i]:
                continue
            props = proposals.get(i, [])
            tokens[i, 0] = self._tokens[i]
            for j, (tok, _q) in enumerate(props):
                tokens[i, 1 + j] = tok
            counts[i] = 1 + len(props)
        try:
            # chaos: a verify fault skips the tick; committed lengths
            # were NOT advanced, so the retried tick is exact
            inject_point("generation.verify_step")
            self._state, logits = self.engine.verify(
                self._state, tokens, counts)
        except FaultError as e:
            self.spec_counters.inc("verify_faults")
            self.counters.inc("step_faults")
            step_span.finish(error=e)
            return live
        self._steps += 1
        self.counters.inc("steps")
        self.spec_counters.inc("verify_ticks")
        self._step_lat.update(self._clock() - t0)
        step_span.finish()
        for i, slot in enumerate(self._slots):
            if slot is None or not self._active[i]:
                continue
            req = slot.request
            props = proposals.get(i, [])
            if not props:
                # no proposals for this slot: row 0 IS the plain-tick
                # logits row — pick with the request's own rule
                emitted, accepted = [req.pick(logits[i][0])], 0
            elif req.mode == "greedy":
                emitted, accepted = greedy_verify(
                    [t for t, _q in props], logits[i])
            else:
                emitted, accepted = rejection_verify(
                    props, logits[i], req.temperature, req._rng)
            self._emit_verified(i, slot, emitted, accepted, len(props))
        return int(self._active.sum())

    def stats(self):
        out = super().stats()
        prop = self.spec_counters.eval()
        out["pool"] = self.engine.pool.stats()
        out["kv_dtype"] = self.engine.kv_dtype
        out["kv_pool_bytes"] = self.engine.kv_pool_bytes()
        out["speculative"] = dict(
            prop, spec_k=self.spec_k,
            accept_rate=(prop["accepted"] / prop["proposed"]
                         if prop["proposed"] else None))
        return out


class GenerationServer:
    """Driver-thread wrapper: a ContinuousBatcher (or, over a
    PagedDecodeEngine, a PagedBatcher) stepping continuously while work
    exists, idling on an event otherwise.

    >>> srv = GenerationServer(engine)
    >>> req = srv.submit([3, 14, 15], max_new_tokens=32, stop_token=1)
    >>> for tok in req.stream(timeout=5.0): ...
    >>> srv.shutdown()
    """

    def __init__(self, engine, max_queue=128, clock=time.monotonic,
                 idle_wait_s=0.005, draft=None, spec_k=None,
                 prefix_reuse=True):
        if isinstance(engine, PagedDecodeEngine):
            self.batcher = PagedBatcher(
                engine, draft=draft, spec_k=spec_k,
                prefix_reuse=prefix_reuse, max_queue=max_queue,
                clock=clock)
        else:
            enforce(draft is None,
                    "a draft needs a PagedDecodeEngine (verify rung)")
            self.batcher = ContinuousBatcher(engine, max_queue=max_queue,
                                             clock=clock)
        self._idle_wait = float(idle_wait_s)
        self._wake = threading.Event()
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._drive,
                                        name="pt-generation-driver",
                                        daemon=True)
        self._thread.start()

    def _drive(self):
        b = self.batcher
        while True:
            if b.closed and (not b._draining or b.idle()):
                break
            live = b.step()
            if live == 0 and b.queue_depth == 0:
                self._wake.wait(self._idle_wait)
                self._wake.clear()
        self._stopped.set()

    def submit(self, prompt, max_new_tokens, stop_token=None,
               mode="greedy", temperature=1.0, seed=0,
               deadline_ms=None, tenant=None, trace_ctx=None,
               request_id=None):
        now = self.batcher._clock()
        req = GenerationRequest(
            prompt, max_new_tokens, enqueued_at=now,
            stop_token=stop_token, mode=mode, temperature=temperature,
            seed=seed,
            deadline=None if deadline_ms is None
            else now + deadline_ms / 1e3,
            tenant=tenant, trace_ctx=trace_ctx)
        req.request_id = request_id
        self.batcher.submit(req)
        self._wake.set()
        return req

    def generate(self, prompt, max_new_tokens, timeout=30.0, **kw):
        """Blocking convenience: returns the full result dict."""
        return self.submit(prompt, max_new_tokens, **kw).result(
            timeout=timeout)

    def stats(self):
        return self.batcher.stats()

    def shutdown(self, drain=True, timeout=30.0):
        self.batcher.close(drain=drain)
        self._wake.set()
        self._stopped.wait(timeout)
        self._thread.join(max(timeout, 0.1))
        return {"drained": self.batcher.idle(),
                "undrained_requests": self.batcher.queue_depth
                + self.batcher.live_slots}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)


def lockstep_generate(engine, requests, clock=time.monotonic):
    """The baseline continuous batching is measured against: fill every
    slot, decode until EVERY member finishes, only then admit the next
    wave. Finished slots keep burning steps (their tokens are
    discarded) and a short request's latency is the wave's longest
    member. Returns (per-request token lists, steps_executed)."""
    state = engine.init_state()
    results = [None] * len(requests)
    steps = 0
    i = 0
    while i < len(requests):
        wave = requests[i:i + engine.batch_size]
        toks = np.zeros(engine.batch_size, np.int32)
        active = np.zeros(engine.batch_size, bool)
        slots = {}
        for s, req in enumerate(wave):
            state, logits = engine.prefill(state, s, req.prompt)
            slot = _Slot(req)
            slots[s] = slot
            active[s] = True
            tok = req.pick(logits)
            slot.last_token = tok
            toks[s] = tok
            req.tokens.append(int(tok))
            slot.produced = 1
        # a wave member is "done" when it hit stop/max — but its slot
        # keeps stepping until the WHOLE wave is done (the lockstep tax)
        def done(s):
            r, sl = slots[s].request, slots[s]
            return (sl.produced >= r.max_new_tokens
                    or (r.stop_token is not None
                        and sl.last_token == r.stop_token))
        while not all(done(s) for s in slots):
            state, logits = engine.step(state, toks, active)
            steps += 1
            for s, slot in slots.items():
                req = slot.request
                tok = req.pick(logits[s])
                toks[s] = tok
                if not done(s):
                    slot.last_token = int(tok)
                    slot.produced += 1
                    req.tokens.append(int(tok))
        for s, slot in slots.items():
            results[i + s] = list(slot.request.tokens)
        i += len(wave)
    return results, steps
