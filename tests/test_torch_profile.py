"""The port's executable profile (observability.profile) against the JAX
package's, on the same numpy inputs: signature labels and the forensics
diff, the ledger's filters, attribution and registry counters, forensics
at a shared site, executable_stats' MFU join on the same records, the
memory ledger's watermark and leak verdicts on the same injected samples,
and the Executor's forensics for a shape-unstable feed. Then the ported
trace scopes, flight recorder and utils.profiler shim.
"""
import json

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.core import flags as jflags
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import profile as jprof
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core import ir as tir
from paddle_tpu_torch.core.executor import Executor as TExecutor
from paddle_tpu_torch.observability import metrics as tmetrics
from paddle_tpu_torch.observability import profile as tprof
from paddle_tpu_torch.observability import recorder as trec
from paddle_tpu_torch.observability import trace as ttrace
from paddle_tpu_torch.utils import profiler as tprofiler


@pytest.fixture(autouse=True)
def _fresh():
    jprof.reset_profile()
    tprof.reset_profile()
    yield
    jprof.reset_profile()
    tprof.reset_profile()


ARGS = ({"x": np.zeros((2, 3), np.float32),
         "ids": np.zeros((2,), np.int32)},
        [np.zeros(4, np.float32), np.zeros((1, 1), bool)], 3)


def test_signatures_and_diffs_are_the_references():
    names = ("feed", "state")
    assert tprof.signature_of(ARGS, names) == jprof.signature_of(ARGS, names)
    assert tprof.signature_of(ARGS) == jprof.signature_of(ARGS)
    assert tprof.dispatch_key(ARGS) == jprof.dispatch_key(ARGS)
    cases = [
        ({"x": np.zeros((2, 3), np.float32)},
         {"x": np.zeros((2, 5), np.float32)}),
        ({"x": np.zeros(3, np.float32)}, {"x": np.zeros(3, np.int32)}),
        ({"x": np.zeros(3, np.float32)},
         {"x": np.zeros(3, np.float32), "y": np.zeros(1, np.int32)}),
        ({"x": np.zeros(3, np.float32), "y": np.zeros(1, np.int32)},
         {"y": np.zeros(1, np.int32)}),
        ({"x": np.zeros(3)}, {"x": np.zeros(3)}),
    ]
    for a, b in cases:
        sa, sb = ((jprof.signature_of((t,), ("feed",)),
                   tprof.signature_of((t,), ("feed",))) for t in (a, b))
        assert sa[0] == sa[1] and sb[0] == sb[1]
        assert (tprof.diff_signatures(sa[1], sb[1])
                == jprof.diff_signatures(sa[0], sb[0]))
    import torch
    # torch tensors read as numpy dtypes, as the JAX package's arrays
    sig = tprof.signature_of((torch.zeros(2, 3), torch.zeros(2, dtype=torch.bool)))
    assert sig == jprof.signature_of((np.zeros((2, 3), np.float32),
                                      np.zeros(2, bool)))


def _drive(prof, led):
    """The same record sequence on either package's ledger."""
    sig1 = prof.signature_of((np.zeros((2, 4), np.float32),), ("x",))
    sig2 = prof.signature_of((np.zeros((8, 4), np.float32),), ("x",))
    led.record(component="a", key="k1", scope="s1", compile_s=0.5)
    led.record(component="a", key="k2", scope="s2", compile_s=0.25,
               tags={"phase": "warmup"})
    with prof.attribution("serving", key="bucket8", scope="srv1",
                          phase="dispatch"):
        led.record(kind="jit", compile_s=1.0)
    led.record(component="t", key="k", site="site1", signature=sig1)
    led.record(component="t", key="k", site="site1", signature=sig2)
    led.record(component="t", key="k", site="site1", signature=sig2)
    led.record(component="t", key="h", compile_s=2.0,
               cache={"event": "hit", "tier": "native", "load_s": 0.1})


def _view(led):
    entries = led.entries()
    return {
        "count": led.count(), "a": led.count(component="a"),
        "s2": led.count(scope="s2"),
        "tag": led.count(tag=("phase", "warmup")),
        "a_s": led.total_compile_s(component="a"),
        "attr": [(e.component, e.key, e.scope, e.tags) for e in
                 led.entries(component="serving")],
        "recompiles": [(e.seq, e.recompile_of, e.forensics)
                       for e in led.recompiles()],
        "paid": len(led.compile_events()),
        "hits": len(led.cache_entries(event="hit")),
        "keys": [(e.component, e.key, e.scope) for e in entries],
        "snapshot": {k: v for k, v in led.snapshot().items()
                     if k != "entries"},
    }


def test_ledger_filters_attribution_forensics_and_counters():
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    jled = jprof.CompileLedger(registry=jreg)
    tled = tprof.CompileLedger(registry=treg)
    _drive(jprof, jled)
    _drive(tprof, tled)
    assert _view(tled) == _view(jled)
    forensics = tled.recompiles()[0].forensics
    assert forensics["changed"][0]["arg"] == "x"
    assert tled.recompiles()[1].forensics is None
    for name in ("pt_compile_events_total", "pt_compile_seconds_total"):
        want = {k: c.value for k, c in
                jreg.families()[name].children().items()}
        got = {k: c.value for k, c in
               treg.families()[name].children().items()}
        assert got == want, name


def test_executable_stats_mfu_join_is_the_references():
    cost = {"flops": 1e6, "bytes accessed": 2e6}
    memory = {"peak_bytes": 832}
    jflags.set_flag("profile_peak_flops", 1e12)
    tflags.set_flag("profile_peak_flops", 1e12)
    try:
        for prof in (jprof, tprof):
            prof.compile_ledger().record(component="u", key="k", cost=cost,
                                         memory=memory)
            for s in (0.001, 0.003):
                prof.observe_run("u", "k", s)
            prof.observe_run("u", "fake", 0.002)
        js, ts = jprof.executable_stats(), tprof.executable_stats()
    finally:
        jflags.set_flag("profile_peak_flops", 0.0)
        tflags.set_flag("profile_peak_flops", 0.0)
    assert set(ts) == set(js) == {"u/k", "u/fake"}
    for key in js:
        for field in ("calls", "total_s", "mean_s", "min_s", "max_s",
                      "flops", "bytes_accessed", "achieved_flops_per_s",
                      "achieved_bytes_per_s", "mfu", "compile_s",
                      "peak_memory_bytes"):
            assert ts[key][field] == pytest.approx(js[key][field]), (
                key, field)
    assert ts["u/k"]["mfu"] == pytest.approx(1e6 / 0.002 / 1e12)
    assert ts["u/fake"]["mfu"] is None


def _samples():
    return [{"buffers": 3, "bytes": 100}, {"buffers": 4, "bytes": 160},
            {"buffers": 4, "bytes": 160}, {"buffers": 6, "bytes": 400},
            {"buffers": 6, "bytes": 420}, {"buffers": 7, "bytes": 500},
            {"buffers": 7, "bytes": 500}, {"buffers": 8, "bytes": 900},
            {"buffers": 2, "bytes": 50}, {"buffers": 3, "bytes": 60}]


def _ledger(prof):
    seq = iter(_samples())
    clock = iter(float(i) for i in range(100))
    return prof.MemoryLedger(capacity=16, read_live=lambda: next(seq),
                             clock=lambda: next(clock))


@pytest.mark.parametrize("window,tolerance", [(8, 0), (4, 0), (8, 1000),
                                              (2, 0), (20, 0)])
def test_memory_ledger_verdicts_are_the_references(window, tolerance):
    jl, tl = _ledger(jprof), _ledger(tprof)
    for i in range(10):
        tag = "warm" if i % 3 == 0 else None
        assert tl.sample(tag=tag) == jl.sample(tag=tag)
        if i in (7, 9):
            assert (tl.leak_report(window=window,
                                   tolerance_bytes=tolerance)
                    == jl.leak_report(window=window,
                                      tolerance_bytes=tolerance))
    assert tl.watermark() == jl.watermark()
    assert tl.leak_report(tag="warm") == jl.leak_report(tag="warm")
    assert tl.snapshot() == jl.snapshot()


def _unstable(pt, program_guard, exe):
    main, startup = pt.Program(), pt.Program()
    with program_guard(main, startup):
        x = pt.static.data("x", [-1, -1], "float32")
        y = pt.static.scale(x, scale=3.0)
    exe.run(startup)
    return main, y


def test_executor_forensics_name_the_feed():
    """TestExecutorForensics of the JAX package's tests, on both: a feed
    whose shape changes is a second signature whose forensics name it;
    steady shapes record once."""
    import paddle_tpu_torch as ptt
    out = {}
    for name, pkg, guard, exe in (
            ("jax", jpt, jpt.program_guard, jpt.Executor()),
            ("torch", ptt, tir.program_guard, TExecutor("cpu"))):
        prof = jprof if name == "jax" else tprof
        main, y = _unstable(pkg, guard, exe)
        prof.reset_profile()
        for cols in (2, 4, 6):
            res = exe.run(main, feed={"x": np.ones((1, cols), np.float32)},
                          fetch_list=[y])
        np.testing.assert_allclose(res[0], 3.0)
        recs = prof.compile_ledger().recompiles()
        out[name] = [[c for c in r.forensics["changed"]
                      if c["arg"].startswith("feed")] for r in recs]
        prof.reset_profile()
        for _ in range(4):
            exe.run(main, feed={"x": np.ones((3, 4), np.float32)},
                    fetch_list=[y])
        assert prof.compile_ledger().count() == 1, name
    assert out["torch"] == out["jax"]
    assert out["torch"][-1][0] == {
        "arg": "feed['x']", "prev_shape": [1, 4], "new_shape": [1, 6],
        "prev_dtype": "float32", "new_dtype": "float32"}
    assert [r.kind for r in tprof.compile_ledger().entries()] == ["eager"]


def test_disabled_ledger_and_snapshot(tmp_path):
    tflags.set_flag("profile_compile_ledger", False)
    try:
        tprof.observe_run("u", "k", 0.001)
        assert tprof.ledger_jit(len, site="s") is len
    finally:
        tflags.set_flag("profile_compile_ledger", True)
    assert tprof.executable_stats() == {}
    tprof.compile_ledger().record(component="c", key="k", compile_s=0.5)
    tprof.observe_run("c", "k", 0.002)
    snap = tprof.profile_snapshot()
    assert snap["ledger"]["events"] == 1 and "c/k" in snap["executables"]
    json.dumps(snap)
    evs = tprof.chrome_events()
    assert {e["cat"] for e in evs} == {"compile", "executable"}
    path = tprofiler.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    assert any(e["name"] == "compile c/k" for e in doc["traceEvents"])


def test_trace_scopes_context_dicts_and_recorder(tmp_path):
    ttrace.reset_tracer()
    with ttrace.span("outer") as outer:
        assert ttrace.current_context() is outer
        inner = ttrace.start_span("inner")
        inner.finish()
    assert inner.parent is outer and ttrace.current_context() is None
    wire = ttrace.context_to_dict(outer)
    from paddle_tpu.observability import trace as jtrace
    ctx = jtrace.context_from_dict(wire)
    assert (ctx.trace_id, ctx.span_id) == (outer.trace_id, outer.span_id)
    assert ttrace.context_from_dict({"trace_id": "zz"}) is None
    with ttrace.attach(wire):
        child = ttrace.start_span("remote child")
    child.finish()
    assert child.trace_id == outer.trace_id
    with tprofiler.RecordEvent("probe.range"):
        pass
    assert tprofiler.summary()["probe.range"]["calls"] >= 1
    tprofiler.log_counters("probe.series", {"a": 1, "b": "x"})
    assert tprofiler.counters("probe.series") == {"a": 1, "b": "x"}
    dump = trec.flight_recorder().dump(str(tmp_path / "d.json"),
                                       reason="test")
    doc = json.load(open(dump))
    kinds = {e["kind"] for e in doc["events"]}
    assert {"counters", "span"} <= kinds
    path = ttrace.export_chrome_trace(str(tmp_path / "c.json"))
    names = {e["name"] for e in json.load(open(path))["traceEvents"]}
    assert {"outer", "inner", "probe.range"} <= names
