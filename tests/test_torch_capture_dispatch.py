"""The capture wrapper's host logic on the CPU (observability.profile.
ProfiledGraph, the port's `jax.jit`).

`torch.cuda`'s graph, stream and memory calls are replaced by recording
stubs and `profile._captures_on` says "capture", so the CUDA path of the
wrapper runs with CPU tensors: the stub graph records its capture and
counts its replays (a replay runs nothing, as a real one runs nothing in
Python). That checks, without a card: one capture per signature (and per
static argument), the inputs copied into the static buffers before each
replay, the static outputs handed back, a replay with another bound
state refused, a failed capture raised with the rung's name and never
run eagerly instead, a Python value refused as an argument, the ledger
flag turning off the ledger and not the capture, the launch counts a
capture saw added on every replay (and not counted for the capture
itself), and `disable_capture()` running eagerly. The real capture runs
on the card (tests/test_torch_capture_cuda.py, chip_smoke phase 31).
"""
import contextlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core import flags
from paddle_tpu_torch.observability import profile as prof


class _Graph:
    """Stands in for torch.cuda.CUDAGraph: counts replays."""

    made = []

    def __init__(self):
        self.replays = 0
        self.captured = False
        self.generators = []
        _Graph.made.append(self)

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        self.replays += 1


class _Stream:
    def wait_stream(self, other):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def cuda_stub(monkeypatch):
    """The wrapper's CUDA calls as recording stubs; yields the record."""
    rec = {"captures": [], "fail": False}

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        rec["captures"].append((g, pool))
        if rec["fail"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        yield
        g.captured = True

    _Graph.made = []
    monkeypatch.setattr(prof, "_captures_on",
                        lambda device: not prof.capture_disabled())
    monkeypatch.setattr(prof, "_capture_streams", {})
    for name, value in (
            ("CUDAGraph", _Graph), ("graph", graph),
            ("graph_pool_handle", lambda: ("pool",)),
            ("Stream", lambda device=None: _Stream()),
            ("current_stream", lambda device=None: _Stream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("memory_allocated", lambda device=None: 0),
            ("max_memory_allocated", lambda device=None: 0),
            ("reset_peak_memory_stats", lambda device=None: None),
            ("memory_snapshot", lambda: [])):
        monkeypatch.setattr(torch.cuda, name, value)
    prof.reset_profile()
    yield rec
    prof.reset_profile()


COUNTS = prof.register_launch_counts({"probe_kernel": 0})


def _probe(calls):
    """fn(x, y, *, k=1): records each Python run and "launches" a kernel
    (bumps COUNTS as a kernel wrapper does)."""

    def fn(x, y, *, k=1):
        calls.append(x.shape)
        COUNTS["probe_kernel"] += 1
        return x * k + y
    return fn


def _wrap(fn, **kw):
    return prof.profiled_graph(fn, "probe", "probe_rung", device="cpu",
                               arg_names=("x", "y"), **kw)


def test_one_capture_per_signature_and_inputs_copied(cuda_stub):
    calls = []
    g = _wrap(_probe(calls), static_argnames=("k",))
    x, y = torch.ones(3), torch.full((3,), 2.0)
    first = g(x, y)
    assert torch.equal(first, torch.full((3,), 3.0))   # the warm-up run
    assert len(calls) == 2       # warm-up + the capture's Python pass
    graph = _Graph.made[0]
    entry = next(iter(g._graphs.values()))
    out = g(torch.full((3,), 5.0), y)
    assert graph.replays == 1 and len(calls) == 2      # no Python run
    # the new inputs were copied into the static buffers before the
    # replay; the outputs are the graph's static tensors
    assert torch.equal(entry.copies[0][1], torch.full((3,), 5.0))
    assert out is entry.outputs
    g(torch.ones(4), torch.ones(4))                      # a new shape
    g(x, y, k=2)                                         # a new static
    assert len(_Graph.made) == 3 and len(cuda_stub["captures"]) == 3
    assert all(p == ("pool",) for _, p in cuda_stub["captures"])
    keys = [r.key for r in prof.compile_ledger().entries(component="probe")]
    assert keys == ["probe_rung", "probe_rung", "probe_rung[k=2]"]
    recs = prof.compile_ledger().entries(component="probe")
    assert all(r.kind == "graph" for r in recs)
    assert recs[1].forensics["changed"][0]["arg"] == "x"
    assert g.compile_count() == 3


def test_replay_with_another_state_raises(cuda_stub):
    state = {"buf": torch.zeros(2)}

    def fn(buf, x):
        buf.add_(x)
        return buf.sum()

    g = prof.profiled_graph(fn, "probe", "bound_rung", device="cpu",
                            arg_names=("buf", "x"),
                            bound=lambda: {"buf": state["buf"]})
    g(state["buf"], torch.ones(2))
    g(state["buf"], torch.ones(2))
    entry = next(iter(g._graphs.values()))
    assert entry.copies[0][0] == 1           # only x is copied
    with pytest.raises(prof.CaptureError, match="not the state"):
        g(torch.zeros(2), torch.ones(2))


def test_failed_capture_raises_and_never_runs_eagerly(cuda_stub):
    calls = []
    COUNTS["probe_kernel"] = 0
    g = _wrap(_probe(calls))
    cuda_stub["fail"] = True
    with pytest.raises(prof.CaptureError, match="probe/probe_rung"):
        g(torch.ones(3), torch.ones(3))
    assert len(calls) == 1          # the warm-up only: no eager retry
    assert not g._graphs
    assert COUNTS["probe_kernel"] == 1


def test_python_values_are_refused(cuda_stub):
    g = _wrap(lambda x, y: x + y)
    with pytest.raises(prof.CaptureError, match="'y' is a int"):
        g(torch.ones(2), 3)
    with pytest.raises(TypeError, match="unknown static"):
        g(torch.ones(2), torch.ones(2), bucket=8)


def test_ledger_flag_off_still_captures(cuda_stub):
    calls = []
    g = _wrap(_probe(calls))
    flags.set_flag("profile_compile_ledger", False)
    try:
        g(torch.ones(3), torch.ones(3))
        g(torch.ones(3), torch.ones(3))
    finally:
        flags.set_flag("profile_compile_ledger", True)
    assert len(_Graph.made) == 1 and _Graph.made[0].replays == 1
    assert prof.compile_ledger().count() == 0


def test_replays_add_the_launch_counts(cuda_stub):
    COUNTS["probe_kernel"] = 0
    g = _wrap(_probe([]))
    g(torch.ones(3), torch.ones(3))
    # the warm-up launched once; the capture's launch did not run
    assert COUNTS["probe_kernel"] == 1
    rec = prof.compile_ledger().entries(component="probe")[-1]
    assert rec.launches == {"probe_kernel": 1}
    for _ in range(3):
        g(torch.ones(3), torch.ones(3))
    assert COUNTS["probe_kernel"] == 4


def test_disable_capture_runs_eagerly(cuda_stub):
    calls = []
    g = _wrap(_probe(calls))
    with prof.disable_capture():
        out = g(torch.ones(3), torch.ones(3))
        g(torch.ones(3), torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    assert len(calls) == 2 and not _Graph.made
    recs = prof.compile_ledger().entries(component="probe")
    assert [r.kind for r in recs] == ["eager"]
    g(torch.ones(3), torch.ones(3))
    assert len(_Graph.made) == 1


def test_numpy_inputs_and_cost(cuda_stub):
    g = _wrap(lambda x, y: x @ y)
    a = np.ones((4, 8), np.float32)
    b = np.ones((8, 2), np.float32)
    out = g(a, b)
    assert out.shape == (4, 2)
    rec = prof.compile_ledger().entries(component="probe")[-1]
    assert rec.signature == (("x", (4, 8), "float32"),
                             ("y", (8, 2), "float32"))
    assert rec.flops == 2 * 4 * 8 * 2          # FlopCounterMode
    prof.note_kernel_flops(7)                  # no open scope: ignored
    assert rec.memory["peak_bytes"] == 0


def test_generator_arguments_are_registered_and_held(cuda_stub):
    """A torch.Generator argument (the counterpart of a JAX key passed to
    the step) is registered with each graph, passed through eagerly, and
    a replay with another generator raises."""
    draws = []

    def fn(x, gen):
        draws.append(torch.rand(x.shape, generator=gen))
        return x + draws[-1]

    g = prof.profiled_graph(fn, "probe", "rng_rung", device="cpu",
                            arg_names=("x", "gen"))
    gen = torch.Generator().manual_seed(3)
    g(torch.ones(2), gen)
    assert _Graph.made[0].generators == [gen]
    g(torch.ones(2), gen)
    assert _Graph.made[0].replays == 1
    with pytest.raises(prof.CaptureError, match="'gen' is not the state"):
        g(torch.ones(2), torch.Generator().manual_seed(3))
    with prof.disable_capture():
        out = g(torch.ones(2), torch.Generator().manual_seed(3))
    assert torch.equal(out, 1 + draws[0])
    assert prof.compile_ledger().entries(component="probe")[0].signature \
        == (("x", (2,), "float32"), ("gen", (), "Generator"))
